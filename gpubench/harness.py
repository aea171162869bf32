"""One run of one cell: set-up, the measured window over
``SLAMSystem.run`` (its last seconds under the profiler in a traced run),
and the check.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that the manifest names, its traffic mix in
``traffic/<name>.json``, its limits in ``limits/<cell>.json``, each
metric's reader in ``metrics/<name>.py``.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

from . import check, record, traffic
from .reference import mast3r_plain

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mast3r_slam_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``mast3r_slam_tpu_torch`` is not ``mast3r_slam_tpu``)."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


# -- the manifest ----------------------------------------------------------------


def load_manifest(root=REPO):
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def cell_spec(workload, root=REPO):
    """(cell, configuration file's dict, mix, per-layer metric entries of
    the cell, end-to-end metric entries of the cell)."""
    man = load_manifest(root)
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = json.loads((pathlib.Path(root) / conf["file"]).read_text())
    mix = traffic.load(cell["traffic"])

    def mine(entry):
        return workload in entry.get("workloads", [workload])

    return (cell, config, mix, [m for m in man["per_layer"] if mine(m)],
            [m for m in man["end_to_end"] if mine(m)])


def load_reader(name):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- weights -------------------------------------------------------------------


def make_weights(m, seed, device):
    """Every parameter of the model with sizes ``m``, drawn on ``device``
    from ``seed`` in one uniform draw a storage dtype: the published
    initializers' bounds for weights, small biases (within 0.02) and
    norm weights within 0.1 of 1, so that the check sees every term. A
    weight is stored in the dtype it is served in (``m["dtype"]`` for the
    transformer, ``m["head_dtype"]`` for the heads, float32 for the last
    head convolution, biases and norms)."""
    dtypes = {"trunk": getattr(torch, m["dtype"]),
              "head": getattr(torch, m["head_dtype"]),
              "head_last": torch.float32, "fp32": torch.float32}
    specs = mast3r_plain.param_specs(m)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = {}
    for key, dt in dtypes.items():
        n = sum(int(np.prod(s[1])) for s in specs if s[3] == key)
        if n:
            flat[key] = torch.empty(n, dtype=dt, device=device).uniform_(
                -1.0, 1.0, generator=g)
    out, at = {}, {k: 0 for k in flat}
    with torch.no_grad():
        for name, shape, init, group in specs:
            n = int(np.prod(shape))
            t = flat[group][at[group]:at[group] + n].view(shape)
            at[group] += n
            if init[0] == "bias":
                t.mul_(0.02)
            elif init[0] == "norm_w":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(mast3r_plain.init_bound(init))
            out[name] = t
    return out


def model_config(m):
    from mast3r_slam_tpu_torch.models.mast3r import MASt3RConfig

    return MASt3RConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in m.items()})


# -- the run ---------------------------------------------------------------------


class Run:
    """One run of a cell. ``sizes`` overrides parts of the configuration
    and the mix (keys ``model``, ``mix``, ``codebook_words``, ``limits``:
    the CPU tests' tiny model, the rate sweep's rates)."""

    def __init__(self, workload, seed, seconds, device="cuda", sizes=None,
                 root=REPO, t_start=None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        (self.cell, self.config, self.mix, self.per_layer,
         self.end_to_end) = cell_spec(workload, root)
        sizes = sizes or {}
        self.m = dict(self.config["model"], **sizes.get("model", {}))
        self.mix = dict(self.mix, **sizes.get("mix", {}))
        cap = dict(self.config["capacity"])
        if "codebook_words" in sizes:
            cap["codebook_words"] = sizes["codebook_words"]
        self.cap = cap
        self.limits = sizes.get("limits") or json.loads(
            (pathlib.Path(root) / "gpubench" / "limits" /
             f"{workload}.json").read_text())
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.dev = torch.device(device)
        self.rec = record.Recorder()
        self.sampler = record.Sampler(self.seed, int(self.config["sample_calls"]))
        self.scans = []
        self.tracer = None

    # -- set-up ------------------------------------------------------------------

    def slam_config(self):
        cfg = copy.deepcopy(self.config["slam"])
        cfg["tracking"]["kf_every"] = int(self.mix["kf_every"])
        if self.mix.get("tracking_window"):
            cfg["runtime"]["tracking_window"] = int(self.mix["tracking_window"])
        return cfg

    def setup(self, trace=False):
        """``trace``: also start and stop the profiler once on a trivial
        op, so that its first start (CUPTI's set-up, seconds) does not
        eat the window's traced part."""
        from mast3r_slam_tpu_torch.models import mast3r, oracle_timing
        from mast3r_slam_tpu_torch.slam import retrieval

        if self.dev.type == "cuda":
            from mast3r_slam_tpu_torch import native
            from mast3r_slam_tpu_torch.ops import _kernels

            _kernels.build_all()
            native.load()
            torch.cuda.reset_peak_memory_stats()
        self.mcfg = model_config(self.m)
        self.weights = make_weights(self.m, self.seed, self.dev)
        self.net = mast3r.build(self.mcfg, device=self.dev)
        self.net.load_state_dict(self.weights, strict=True)
        g = torch.Generator(device=self.dev).manual_seed(
            (self.seed + 1) % 2 ** 63)
        self.rparams = retrieval.init_retrieval_params(
            g, backbone_dim=self.m["enc_embed_dim"],
            codebook_size=int(self.cap["codebook_words"]), device=self.dev)
        self.slam_cfg = self.slam_config()
        self.h, self.w = self.m["img_size"]
        self.source = traffic.Scans(self.mix, self.seed, self.h, self.w)
        self.shim = record.NetworkShim(oracle_timing, self.rec, self.sampler)
        self.shim.install()
        self.waiter = record.Waiter(self.rec)
        self.probe = record.Probe(self.rec, self.waiter)
        self.clock = traffic.Clock(self.mix, self.seconds)
        # a short scan of the cell's own shapes warms every kernel and
        # cuBLAS; then the window's scan and its system are made
        traj, ds = self.source.scan(-1, n=int(self.mix["warm_frames"]))
        self.run_scan(-1, traj, ds, self.new_system(traj))
        self.first = self.prepare(0)
        if trace:
            with Tracer.profile(self.dev):
                torch.ones(1, device=self.dev).add_(1)
                self.sync()
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        log(f"set-up {self.setup_s:.3f} s")

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -- one scan ------------------------------------------------------------------

    def new_system(self, traj):
        from mast3r_slam_tpu_torch.models import oracle, oracle_timing
        from mast3r_slam_tpu_torch.slam.system import SLAMSystem

        with self.rec.span("system_init"):
            orc = oracle.make_params(
                torch.from_numpy(traj).to(self.dev),
                desc_dim=self.m["desc_dim"],
                desc_freq=float(self.mix["desc_freq"]), device=self.dev)
            return SLAMSystem(
                oracle_timing.make_params(self.net, orc), self.mcfg,
                self.slam_cfg, (self.h, self.w),
                retrieval_params=self.rparams,
                keyframe_capacity=int(self.cap["keyframes"]),
                edge_capacity=int(self.cap["edges"]),
                model_module=self.shim, device=self.dev)

    def prepare(self, c):
        """Scan ``c`` of the window: its poses, its dataset on the window's
        clock, and its system."""
        traj, ds = self.source.scan(c, clock=self.clock, counter=self.rec)
        return traj, ds, self.new_system(traj)

    def run_scan(self, c, traj, ds, system):
        """Drive ``system`` over scan ``c`` until it ends or the window
        closes. A scan cut by the close gets what ``run`` does at a scan's
        end, after the close and outside the window: the queued keyframes'
        backend steps and the edge gates' flush. Then its state is read."""
        rec = self.rec
        rec.scan = c
        rec.pending = []
        res = {"scan": c, "traj": traj, "phase": ds.phase, "track_ids": [],
               "track_T": [], "finished": False}
        wrapped = self._wrap(system, res)
        try:
            system.run(ds, viewer=self.probe)
            res["finished"] = True
        except traffic.WindowClosed:
            self.close_window()
            while system.backend_step():
                pass
            system.factor_graph.flush()
        finally:
            # the wrappers hold the system: drop them so that it is freed
            # as soon as this scan's results are taken
            for name in wrapped:
                delattr(system, name)
        res["stats"] = dict(system.stats)
        res["frames_run"] = n = system.last_frame_idx
        # the backend is checked on scans that ran one orbit at least
        if n >= int(self.mix["orbit_frames"]):
            kfs, fg = system.keyframes, system.factor_graph
            k, e = len(kfs), fg.n_edges
            res.update(
                checked=True,
                kf_T=kfs.T_WC[:k].clone(), kf_idx=kfs.dataset_idx[:k].clone(),
                ii=fg.ii[:e].clone(), jj=fg.jj[:e].clone(),
                health=check.health_problems(
                    system.stats, system.mode.name, e, fg.edges_dropped, n,
                    int(self.mix["kf_every"])))
        return res

    def _wrap(self, system, res):
        """Instance wrappers: a span around each call into the system's
        layers, and the tracker's pose of each frame it tracked."""
        rec = self.rec

        def spanned(name, fn, did=False):
            def call(*a, **k):
                with rec.span(name) as ex:
                    out = fn(*a, **k)
                    if did:
                        ex["did"] = bool(out)
                return out
            return call

        system.make_frame = spanned("make_frame", system.make_frame)
        system.dispatch_window = spanned("dispatch_window",
                                         system.dispatch_window)
        system.backend_step = spanned("backend_step", system.backend_step,
                                      did=True)
        orig_consume = spanned("consume_window", system.consume_window)
        orig_process = spanned("process_frame", system.process_frame)

        def consume_window(pending):
            k = orig_consume(pending)
            out, ids = pending[0], pending[1]
            ok = k - (system.mode.name == "RELOC")
            if ok > 0:
                res["track_ids"] += list(ids[:ok])
                res["track_T"].append(out.T_WCf[:ok])
            return k

        def process_frame(frame):
            before = system.mode.name
            out = orig_process(frame)
            if before in ("INIT", "TRACKING") and system.mode.name == "TRACKING":
                res["track_ids"].append(frame.frame_id)
                res["track_T"].append(frame.T_WC.reshape(1, 8))
            return out

        system.consume_window = consume_window
        system.process_frame = process_frame
        return ("make_frame", "dispatch_window", "backend_step",
                "consume_window", "process_frame")

    # -- the window ----------------------------------------------------------------

    def window(self, trace_seconds=0.0):
        """The measured window: the scan made in set-up, and a next one
        with a system of its own should it end before the close. With
        ``trace_seconds`` the window's last seconds run under
        ``torch.profiler`` (``self.tracer``)."""
        rec, clock = self.rec, self.clock
        rec.phase = "window"
        self.tracer = None
        clock.open()
        if trace_seconds:
            self.tracer = Tracer(self, clock.closes - trace_seconds)
            rec.on_take = self.tracer.poll
        c, nxt = 0, self.first
        self.first = None
        cpu0 = time.process_time()
        while True:
            res = self.run_scan(c, *nxt)
            nxt = None
            self.scans.append(res)
            if not res["finished"]:
                break
            now = time.perf_counter()
            due = clock.due(rec.index)
            if (due if due is not None else now) >= clock.closes:
                break
            c += 1
            nxt = self.prepare(c)
        self.close_window()
        cpu = time.process_time() - cpu0
        self.waiter.close()
        # the process's CPU seconds over the window, beside its wall
        # seconds: a slower host shows here first
        done = [f[4] - clock.t0 for f in rec.frames]
        self.host = {"cpu_s": cpu,
                     "wall_s": time.perf_counter() - clock.t0,
                     "loadavg": os.getloadavg()[0],
                     "frames_by_5s": np.bincount(
                         (np.asarray(done) // 5).astype(int).clip(0)
                     ).tolist() if done else []}

    def close_window(self):
        """What follows the close: later spans and calls are the run's
        ``after`` phase, the profiler stops, the device finishes."""
        self.rec.phase = "after"
        self.rec.on_take = None
        if self.tracer is not None:
            self.tracer.stop()
        self.sync()

    # -- results -------------------------------------------------------------------

    def host_results(self):
        """The scans' answers read back to the host (after the window)."""
        out = []
        for r in self.scans:
            h = dict(r)
            h["track_T"] = (torch.cat(r["track_T"]).cpu().numpy()
                            if r["track_T"] else np.zeros((0, 8), np.float32))
            if r.get("checked"):
                for k in ("kf_T", "kf_idx", "ii", "jj"):
                    h[k] = r[k].cpu().numpy()
            out.append(h)
        return out

    def checks(self, scans):
        """(compared, readings, detail): ``compared`` [(name, value,
        limit)] holds the numbers this cell's limits file names and the
        exact counts (limit 0); ``readings`` every number the check
        computes."""
        samples = [s for kind in record.KINDS
                   for s in self.sampler.kept[kind]]
        trajs = {r["scan"]: r["traj"] for r in self.scans}
        errs = check.net_errors(samples, self.weights, self.m, trajs)
        worst = max(errs, key=lambda e: e[2]) if errs else None
        gf, hf, detail = check.graph_and_health(scans)
        if worst:
            detail.append(f"network's largest error: {worst[0]} {worst[1]} "
                          f"over {len(samples)} sampled calls")
        readings = check.net_numbers(errs)
        readings.update(check.pose_numbers(scans))
        compared = [(k, readings[k], v) for k, v in self.limits.items()]
        compared += [("graph_faults", gf, 0), ("health_faults", hf, 0),
                     ("refused_calls", len(self.shim.refused), 0)]
        return compared, readings, detail


class Tracer:
    """``torch.profiler`` over the window's last seconds: ``poll`` (called
    as each frame is taken) starts it once the host clock passes
    ``start_at``; ``stop`` ends it at the close. The benchmark's spans
    become ``record_function`` ranges inside it, and the range
    ``trace_window`` marks its length. Both ends wait for the device, so
    that the trace holds the work launched inside it and nothing else."""

    def __init__(self, run, start_at):
        self.run = run
        self.start_at = start_at
        self.prof = self.range = self.t0 = None
        self.stopped = False

    @staticmethod
    def profile(dev):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def poll(self):
        if (self.prof is not None or self.stopped
                or time.perf_counter() < self.start_at):
            return
        from torch.profiler import record_function

        self.run.sync()
        self.prof = self.profile(self.run.dev)
        self.prof.start()
        self.range = record_function("trace_window")
        self.range.__enter__()
        self.run.rec.profile_ranges = True
        self.t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.stopped:
            return
        self.stopped = True
        self.run.sync()
        self.run.rec.profile_ranges = False
        self.range.__exit__(None, None, None)
        self.prof.stop()

"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for Hopper
(``sm_90a``) into ``build/torch_kernels/lib<name>.so``, a shared library
with a plain C interface that ``ctypes`` loads. A library is rebuilt when
its own source or a shared header (``csrc/*.cuh``) is newer than it, not
when another kernel's source changed. Nothing is built at import
time, and nothing is built for CPU tensors: the wrappers take the plain
PyTorch versions there. ``build_all()`` starts one ``nvcc`` per source at
once so a fresh checkout builds in the time of the slowest file.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else. A launch into a CUDA graph
under capture runs nothing: inside ``tally_launches`` a thread's launches
are counted into the graph's tally instead, and each replay of the graph
adds the tally (``add_launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

# kernel source name -> (C symbol, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SOURCES = {
    "scharr_rays": ("scharr_rays_launch", [_P, _P] + [_I] * 10 + [_P]),
    "iter_proj": ("iter_proj_launch",
                  [_P] * 5 + [_I] * 7 + [_F, _F, _P]),
    "refine_matches": ("refine_matches_launch",
                       [_P] * 4 + [_I] * 9 + [_P]),
    "refine_separable": ("refine_separable_launch",
                         [_P] * 4 + [_I] * 9 + [_P]),
    "gather_rows": ("gather_rows_launch", [_P, _P, _P, _I, _I, _I, _P]),
    "take_along": ("take_along_launch", [_P] * 6 + [_I] * 5 + [_P]),
    "gn_step": ("gn_step_launch",
                [_P] * 8 + [_I] * 4 + [_F] * 11 + [_P]),
    "ba_edge_terms": ("ba_edge_terms_launch",
                      [_P] * 21 + [_I] * 7 + [_F] * 13 + [_P]),
    "coarse_correlate": ("coarse_correlate_launch", [_P] * 3 + [_I] * 6 + [_P]),
    "rope_qk": ("rope_qk_launch", [_P] * 8 + [_L] * 8 + [_I] * 7 + [_P]),
    "rope_qk_bwd": ("rope_qk_bwd_launch",
                    [_P] * 8 + [_L] * 2 + [_I] * 7 + [_P]),
    "conv2d_3xtf32": ("conv2d_3xtf32_launch", [_P] * 5 + [_I] * 14 + [_P]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

LAUNCHES = {name: 0 for name in SOURCES}

_libs: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()
_tally = threading.local()      # .counts: this thread's tally, or None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def tally_launches():
    """Inside the block this thread's launches are counted into the
    yielded dict (kernel name -> launches), not into ``LAUNCHES``."""
    counts = dict.fromkeys(SOURCES, 0)
    _tally.counts = counts
    try:
        yield counts
    finally:
        _tally.counts = None


def add_launches(counts):
    """Add ``counts`` (kernel name -> launches) to ``LAUNCHES``."""
    with _count_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return found


def _lib_path(name):
    return BUILD_DIR / f"lib{name}.so"


def _stale(name):
    so = _lib_path(name)
    if not so.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def _start_build(name):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish_build(name, proc, tmp):
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))   # atomic: readers never see half a file
    return out


def build_all(names=None):
    """Compile every stale kernel source in parallel; returns
    {name: compiler output} for the sources that were built."""
    names = list(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if _stale(n)]
        started = [(n, *_start_build(n)) for n in todo]
        return {n: _finish_build(n, p, t) for n, p, t in started}


def library(name):
    """The loaded ctypes library of kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            sym, argtypes = SOURCES[name]
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def launch(name, *args):
    """Call kernel ``name``'s C launcher; raises if the launch reported a
    CUDA error. Counts the launch.

    Tensor arguments are passed as tensors and become device pointers here.
    They must all lie on one device: the kernel launches there, with that
    device current and on its current stream, whatever device the calling
    thread has current. So a kernel of the backend on a second GPU is
    ordered with the PyTorch work on that GPU's stream."""
    import torch

    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"CUDA kernel {name}: its tensors lie on "
                         f"{sorted(map(str, devices))}, not on one device")
    (dev,) = devices
    c_args = [ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
    fn = getattr(library(name), SOURCES[name][0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = fn(*c_args, ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    counts = getattr(_tally, "counts", None)
    with _count_lock:     # the backend thread of SLAMSystem.run launches too
        (LAUNCHES if counts is None else counts)[name] += 1


@functools.lru_cache(maxsize=None)
def sm_count(device_index):
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(t, name, dtype=None, ndim=None, last=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype,
    rank and trailing size."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name}: expected trailing size {last}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

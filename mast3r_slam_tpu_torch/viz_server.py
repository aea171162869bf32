"""Live reconstruction viewer served over HTTP during a run.

Counterpart of ``mast3r_slam_tpu/viz_server.py``: ``pack_scene`` (:39) and
``unpack_scene`` (:62) keep its ``/scene`` wire format byte for byte, and
``LiveViewer`` (:89) its endpoints, per-run token, POST-only ``/ctrl`` and
pause/step. A stdlib HTTP server in a daemon thread serves the WebGL page
(``viz.live_html``), which polls ``/scene`` and posts pause, step and
confidence-threshold commands that the run loop honours between frames.

The snapshot owns its data. The JAX package's shallow copy of the store
is a snapshot because JAX arrays are immutable; the port's store is
written in place (``KeyframeStore.set_frame``, the window chain's row
writes, bundle adjustment's poses). So ``update`` enqueues, under
``system.state_lock``, the device work that produces the scene's inputs
into fresh tensors (``viz.scene_snapshot``): it sits on the stream that
writes the store, so it is ordered before any later write. The selection
and the one readback run outside the lock (``viz.render_scene``), and a
``set_conf_threshold`` while paused re-renders from the same snapshot.
Until a refresh is due, ``update`` reads host values only (the frame
index and a clock): no device work, no wait.
"""

from __future__ import annotations

import contextlib
import secrets
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import viz

MAGIC = 0x4D534C4D  # "MSLM"
VERSION = 1


def pack_scene(scene, n_kf=0, frame=0, paused=False):
    """Serialize a viz.build_scene dict into the /scene wire format.

    Layout (little-endian): 8 x u32 header [magic, version, npts, nlines,
    n_kf, frame, paused, 0], 4 x f32 [center xyz, scale], then npts*3 f32
    points, npts*3 u8 colors, zero-pad to 4-byte alignment, nlines*3 f32
    line endpoints, nlines*3 u8 line colors. The JS client in
    viz._LIVE_INIT_JS computes the same offsets from the counts.
    """
    pts = np.ascontiguousarray(scene["pts"], np.float32)
    cols = np.ascontiguousarray(scene["cols"], np.uint8)
    lpts = np.ascontiguousarray(scene["lpts"], np.float32)
    lcols = np.ascontiguousarray(scene["lcols"], np.uint8)
    c = np.asarray(scene["center"], np.float32)
    head = struct.pack("<8I", MAGIC, VERSION, len(pts), len(lpts),
                       int(n_kf), int(frame), int(bool(paused)), 0)
    head += struct.pack("<4f", float(c[0]), float(c[1]), float(c[2]),
                        float(scene["scale"]))
    body = pts.tobytes() + cols.tobytes()
    body += b"\0" * ((-len(body)) % 4)
    return head + body + lpts.tobytes() + lcols.tobytes()


def unpack_scene(blob):
    """Inverse of pack_scene (used by tests and programmatic clients)."""
    magic, ver, npts, nlines, n_kf, frame, paused, _ = struct.unpack_from(
        "<8I", blob, 0)
    assert magic == MAGIC and ver == VERSION
    cx, cy, cz, scale = struct.unpack_from("<4f", blob, 32)
    off = 48
    pts = np.frombuffer(blob, np.float32, npts * 3, off).reshape(-1, 3)
    off += npts * 12
    cols = np.frombuffer(blob, np.uint8, npts * 3, off).reshape(-1, 3)
    off += npts * 3
    off = (off + 3) & ~3
    lpts = np.frombuffer(blob, np.float32, nlines * 3, off).reshape(-1, 3)
    off += nlines * 12
    lcols = np.frombuffer(blob, np.uint8, nlines * 3, off).reshape(-1, 3)
    return {"pts": pts, "cols": cols, "lpts": lpts, "lcols": lcols,
            "center": np.array([cx, cy, cz], np.float32), "scale": scale,
            "n_kf": n_kf, "frame": frame, "paused": bool(paused)}


_EMPTY = pack_scene({"pts": np.zeros((0, 3), np.float32),
                     "cols": np.zeros((0, 3), np.uint8),
                     "lpts": np.zeros((0, 3), np.float32),
                     "lcols": np.zeros((0, 3), np.uint8),
                     "center": np.zeros(3, np.float32), "scale": 1.0})


class LiveViewer:
    """HTTP live viewer and run-loop pause/step control.

    Usage:
        viewer = LiveViewer(port=8080).start()
        system.run(dataset, viewer=viewer); viewer.stop()

    The run loop calls ``update(system)`` after each frame or window
    (throttled by ``refresh_s``) and ``wait_if_paused()`` before the next.
    """

    def __init__(self, port=0, c_conf_threshold=1.5, max_points=400_000,
                 refresh_s=2.0, host="127.0.0.1"):
        self.c_conf_threshold = c_conf_threshold
        self.max_points = max_points
        self.refresh_s = refresh_s
        self.paused = False
        self._step = threading.Event()
        self._blob = _EMPTY
        self._blob_lock = threading.Lock()
        self._last_update = 0.0
        self._frame = 0
        # per-run control token embedded in the served page: /ctrl requires
        # it (and POST), so a hostile page in the operator's browser cannot
        # pause or resume a run with a bare GET
        self.token = secrets.token_hex(8)
        # the latest update()'s viz.SceneSnapshot: a threshold change
        # re-renders from it without a new frame
        self._last_snap = None
        self._colours = viz.ColourCache()
        # the latest refresh: build time (ms) and bytes read back
        self.last_render = {}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html",
                               viz.live_html(viewer.token).encode())
                elif u.path == "/scene":
                    with viewer._blob_lock:
                        blob = viewer._blob
                    self._send(200, "application/octet-stream", blob)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path != "/ctrl":
                    self._send(404, "text/plain", b"not found")
                    return
                if q.get("t", [""])[0] != viewer.token:
                    self._send(403, "text/plain", b"bad token")
                    return
                if "conf" in q:
                    # the confidence slider: re-renders the served scene at
                    # once, also while paused
                    try:
                        viewer.set_conf_threshold(float(q["conf"][0]))
                    except ValueError:
                        pass
                was_paused = viewer.paused
                if "toggle" in q:
                    viewer.paused = not viewer.paused
                elif "pause" in q:
                    viewer.paused = q["pause"][0] not in ("0", "false")
                if viewer.paused and not was_paused:
                    viewer._step.clear()   # no stale step past a new pause
                if "step" in q and viewer.paused:
                    viewer._step.set()     # a step only means something paused
                self._send(200, "application/json",
                           b'{"paused": %s}'
                           % (b"true" if viewer.paused else b"false"))

        # localhost by default: the reconstruction is not exposed on the
        # network unless asked for (host="0.0.0.0")
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    # -- run-loop hooks --------------------------------------------------------

    def update(self, system, force=False):
        """Rebuild the served scene if ``refresh_s`` has passed (or
        ``force``): the snapshot under ``system.state_lock``, the selection
        and readback outside it."""
        self._frame = getattr(system, "last_frame_idx", self._frame)
        now = time.monotonic()
        if not force and now - self._last_update < self.refresh_s:
            return
        self._last_update = now
        lock = getattr(system, "state_lock", None)
        with lock if lock is not None else contextlib.nullcontext():
            snap = viz.scene_snapshot(system.keyframes, system.factor_graph,
                                      self._colours)
        self._last_snap = snap
        self._render(snap)

    def _render(self, snap):
        t0 = time.perf_counter()
        scene = viz.render_scene(snap, self.c_conf_threshold,
                                 self.max_points)
        blob = pack_scene(scene, n_kf=snap.T_WC.shape[0], frame=self._frame,
                          paused=self.paused)
        with self._blob_lock:
            self._blob = blob
        self.last_render = {"ms": (time.perf_counter() - t0) * 1e3,
                            "readback_bytes": scene["readback_bytes"],
                            "points": len(scene["pts"])}

    def set_conf_threshold(self, value: float):
        """Change the point-cloud confidence threshold and re-render the
        served scene from the latest snapshot (the slider works while the
        run is paused); the next ``update`` uses the new value too."""
        self.c_conf_threshold = float(value)
        self._last_update = 0.0
        snap = self._last_snap
        if snap is not None:
            self._render(snap)

    def wait_if_paused(self):
        """Block while paused; a queued step request releases one frame."""
        while self.paused:
            if self._step.is_set():
                self._step.clear()
                return
            time.sleep(0.05)

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

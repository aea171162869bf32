"""ctypes binding of the native ASMK engine (``asmk_native.cpp``).

A copy of ``mast3r_slam_tpu/native/__init__.py`` with one difference:
``load()`` builds ``libasmk_native.so`` from the source beside this file
with ``g++`` at first use, into ``build/torch_kernels/`` (no binary is
checked in, and the JAX package's library is never loaded), and **raises**
if the build or the load fails. The numpy inverted file of
``slam/retrieval.py`` is used only when the caller asks for it
(``RetrievalDatabase(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..ops._kernels import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "asmk_native.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-mpopcnt", "-shared"]

_LIB = None
_lock = threading.Lock()


def lib_path() -> pathlib.Path:
    return BUILD_DIR / "libasmk_native.so"


def build() -> pathlib.Path:
    """Compile the library if it is missing or older than its source."""
    so = lib_path()
    if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"could not run {CXX} to build the native ASMK "
                           f"library: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError("building the native ASMK library failed:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)      # atomic: readers never see half a file
    return so


def load():
    """The bound library, built at first use; raises if that fails."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        i64, dbl, ptr = ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
        lib.asmk_binarize_pack.argtypes = [ptr, i64, i64, ptr]
        lib.asmk_hamming_cdist.argtypes = [ptr, i64, ptr, i64, i64, ptr]
        lib.asmk_ivf_create.restype = ptr
        lib.asmk_ivf_create.argtypes = [i64, i64]
        lib.asmk_ivf_destroy.argtypes = [ptr]
        lib.asmk_ivf_n_images.restype = i64
        lib.asmk_ivf_n_images.argtypes = [ptr]
        lib.asmk_ivf_add.argtypes = [ptr, ptr, ptr, i64, i64]
        lib.asmk_ivf_search.argtypes = [ptr, ptr, ptr, i64, dbl, dbl, ptr]
        lib.asmk_ivf_n_entries.restype = i64
        lib.asmk_ivf_n_entries.argtypes = [ptr]
        lib.asmk_ivf_export.argtypes = [ptr, ptr, ptr, ptr]
        lib.asmk_ivf_import.argtypes = [ptr, ptr, ptr, ptr, i64]
        _LIB = lib
        return _LIB


def _cptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


class NativeIVF:
    """C++ inverted file with the interface of ``retrieval.IVF``."""

    def __init__(self, n_words: int, dim: int, lib=None):
        self.lib = lib or load()
        self.n_words = n_words
        self.dim = dim
        self.handle = self.lib.asmk_ivf_create(n_words, dim)

    def __del__(self):
        if getattr(self, "handle", None) and self.lib:
            self.lib.asmk_ivf_destroy(self.handle)
            self.handle = None

    @property
    def n_images(self):
        return int(self.lib.asmk_ivf_n_images(self.handle))

    def add_packed(self, packed: np.ndarray, words: np.ndarray, imid: int):
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        words = np.ascontiguousarray(words, dtype=np.int64)
        self.lib.asmk_ivf_add(self.handle, _cptr(packed), _cptr(words),
                              len(words), int(imid))

    def flat_state(self):
        """Every posting entry as flat arrays (a checkpoint-friendly
        snapshot, the counterpart of the numpy IVF's ``flat_state``)."""
        n = int(self.lib.asmk_ivf_n_entries(self.handle))
        wpv = (self.dim + 63) // 64
        vecs = np.zeros((n, wpv), dtype=np.uint64)
        words = np.zeros(n, dtype=np.int64)
        imids = np.zeros(n, dtype=np.int64)
        if n:
            self.lib.asmk_ivf_export(self.handle, _cptr(vecs), _cptr(words),
                                     _cptr(imids))
        return {"kind": "native", "n_words": self.n_words, "dim": self.dim,
                "vecs": vecs, "words": words, "imids": imids}

    @classmethod
    def from_flat(cls, state):
        ivf = cls(int(state["n_words"]), int(state["dim"]))
        vecs = np.ascontiguousarray(state["vecs"], dtype=np.uint64)
        words = np.ascontiguousarray(state["words"], dtype=np.int64)
        imids = np.ascontiguousarray(state["imids"], dtype=np.int64)
        if len(words):
            ivf.lib.asmk_ivf_import(ivf.handle, _cptr(vecs), _cptr(words),
                                    _cptr(imids), len(words))
        return ivf

    def search_packed(self, packed: np.ndarray, words: np.ndarray,
                      alpha: float, sim_thresh: float) -> np.ndarray:
        packed = np.ascontiguousarray(packed, dtype=np.uint64)
        words = np.ascontiguousarray(words, dtype=np.int64)
        scores = np.zeros(self.n_images, dtype=np.float32)
        if self.n_images:
            self.lib.asmk_ivf_search(self.handle, _cptr(packed), _cptr(words),
                                     len(words), float(alpha),
                                     float(sim_thresh), _cptr(scores))
        return scores


def binarize_pack64(des: np.ndarray) -> np.ndarray:
    """(n, dim) float -> (n, ceil(dim/64)) uint64 packed sign bits."""
    lib = load()
    des = np.ascontiguousarray(des, dtype=np.float32)
    n, dim = des.shape
    out = np.zeros((n, (dim + 63) // 64), dtype=np.uint64)
    lib.asmk_binarize_pack(_cptr(des), n, dim, _cptr(out))
    return out

"""Host-side runtime: the threaded prefetching ``.npy`` batch loader (port of
ganecdotes_tpu/runtime/__init__.py).

``NativeDataLoader`` wraps the port's own copy of the C++ loader
(``src/loader.cpp``) through ctypes. ``g++`` builds it at first use, never
at import, into ``build/loader/`` (listed in .gitignore), named by a hash of
the source; the library is written to a temporary file and moved into place
with ``os.replace``, so processes that build at once (the tests run in
several) never load a half-written file.

Unlike the JAX package's ``make_loader``, which falls back to a Python
loader without a word, the port has the native loader only: where it cannot
be built or loaded, ``NativeDataLoader`` raises with the build error.

With one worker thread the native loader's batches are the JAX package's
native loader's, in the same order, for the same files and seed; with more,
the threads race for the queue and the order of the batches varies.

While spans record (``utils/tracing.py``), each ``next`` counts the ms it
waited on an empty queue, the worker threads behind, as ``loader.starved``.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ganecdotes_torch import ROOT_DIR
from ganecdotes_torch.utils import tracing

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "loader.cpp")
BUILD_DIR = os.path.join(ROOT_DIR, "build", "loader")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lock = threading.Lock()


def _library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgxloader_{h.hexdigest()[:16]}.so")


def _build(so):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++
        raise RuntimeError(f"native loader: cannot run {cmd[0]}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native loader: {' '.join(cmd)} failed:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)


def load_native():
    """The native loader's library, built first if the source changed.
    Raises RuntimeError with the build error where it cannot be built or
    loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.gx_open.restype = ctypes.c_void_p
        lib.gx_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
        ]
        lib.gx_next.restype = ctypes.c_int
        lib.gx_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        lib.gx_last_starved_ns.restype = ctypes.c_longlong
        lib.gx_last_starved_ns.argtypes = [ctypes.c_void_p]
        for name in ("gx_batches", "gx_errors", "gx_epoch"):
            getattr(lib, name).restype = ctypes.c_long
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.gx_close.restype = None
        lib.gx_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeDataLoader:
    """Endless shuffled (B, H, W, C) float32 batches from .npy image files,
    decoded by the C++ loader's worker threads."""

    def __init__(self, paths, batch, h, w, c, queue_depth=4, n_threads=4,
                 seed=0, shuffle=True, normalize=True):
        if not paths:
            raise ValueError("NativeDataLoader: no paths")
        lib = load_native()
        self._lib = lib
        self.batch, self.h, self.w, self.c = batch, h, w, c
        arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._handle = lib.gx_open(arr, len(paths), batch, h, w, c, queue_depth,
                                   n_threads, seed, int(shuffle), int(normalize))
        if not self._handle:
            raise RuntimeError("gx_open failed")
        self._final_stats = (0, 0, 0)
        self._buf = np.empty((batch, h, w, c), dtype=np.float32)

    def next(self):
        if not self._handle:
            raise StopIteration
        rc = self._lib.gx_next(self._handle,
                               self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise StopIteration
        if tracing.recording():
            tracing.count("loader.starved",
                          self._lib.gx_last_starved_ns(self._handle) / 1e6)
        return self._buf.copy()

    __next__ = next

    def __iter__(self):
        return self

    @property
    def batches_produced(self):
        if not self._handle:
            return self._final_stats[0]
        return int(self._lib.gx_batches(self._handle))

    @property
    def decode_errors(self):
        if not self._handle:
            return self._final_stats[1]
        return int(self._lib.gx_errors(self._handle))

    @property
    def epoch(self):
        if not self._handle:
            return self._final_stats[2]
        return int(self._lib.gx_epoch(self._handle))

    def close(self):
        """Stop and join the worker threads; the counts stay readable."""
        if self._handle:
            self._final_stats = (self.batches_produced, self.decode_errors, self.epoch)
            self._lib.gx_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()

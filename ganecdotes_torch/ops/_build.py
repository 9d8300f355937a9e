"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one shared library.

Route: ``nvcc`` by hand into a ``.so`` with a plain C interface, loaded with
``ctypes`` (every pointer and the stream passed as ``c_void_p``). Each source
compiles to an object file in its own ``nvcc`` process, all started together,
and one more ``nvcc`` links them, so the build takes about as long as its
slowest source however many sources later slices add. The library is built at first use under
``BUILD_DIR``, named by a hash of the sources and flags, so an unchanged tree
loads the library it built before.

Every C entry launches on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; ``launch`` raises when that is not 0 and
counts the launch. Nothing here runs at import: the package must import,
and run its plain path, where there is no ``nvcc`` and no card.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from ganecdotes_torch import BUILD_DIR, PKG_DIR
from ganecdotes_torch.utils import tracing

CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
]

# Launch counts, one per kernel. Each wrapper adds one where it launches its
# kernel and nowhere else, so a run can show which kernels the path reached.
LAUNCHES = {
    "fused_leaky_relu": 0,
    "fused_leaky_relu_bwd": 0,
    "upfirdn2d": 0,
    "styled_conv3x3": 0,
    "styled_up_conv3x3": 0,
    "sinkhorn_knopp": 0,
    "resample_rows": 0,
    "resample_rows_t": 0,
}
# The bfloat16 instances of the kernels that take bf16 (every one but the
# Sinkhorn's), counted apart: a bf16 run shows that it reached them.
BF16_KERNELS = ("fused_leaky_relu", "fused_leaky_relu_bwd", "upfirdn2d",
                "styled_conv3x3", "styled_up_conv3x3", "resample_rows",
                "resample_rows_t")
LAUNCHES.update({k + "_bf16": 0 for k in BF16_KERNELS})
# the element types the kernels take, one per launch
DTYPES = (torch.float32, torch.bfloat16)

# what the last ``load`` did: seconds, whether it compiled, the log path
BUILD_INFO = {}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
KMAX = 16  # most taps per axis upfirdn2d takes (taps pass by value)


class Taps(ctypes.Structure):
    """The separable FIR's 1-D taps, passed by value to the upfirdn2d
    kernel: taps_y and taps_x (the first kh and kw of each are used)."""

    _fields_ = [("ky", ctypes.c_float * KMAX), ("kx", ctypes.c_float * KMAX),
                ("kh", ctypes.c_int), ("kw", ctypes.c_int)]


_SIGNATURES = {
    # x, bias (or NULL), mask source (or NULL), y, rows, C, negative_slope,
    # scale, the plan (vec, tx, ty, gx, gy), stream
    "gk_fused_leaky_relu": [P, P, P, P, I, I, F, F] + [I] * 5 + [P],
    # g, y, dx, partial sums (or NULL), db (or NULL), rows, C,
    # negative_slope, scale, the plan, stream
    "gk_fused_leaky_relu_bwd": [P] * 5 + [I, I, F, F] + [I] * 5 + [P],
    # x, y, B, H, W, C, OH, OW, up_x, up_y, down_x, down_y, pad_x0, pad_y0,
    # the tile (toh, tow, ct, ih, iw, vec, threads, vpass), taps, stream
    "gk_upfirdn2d": [P, P] + [I] * 20 + [Taps, P],
    # the bf16 instances of the three above, same arguments (fused act's
    # backward: its partial sums float32)
    "gk_fused_leaky_relu_bf16": [P, P, P, P, I, I, F, F] + [I] * 5 + [P],
    "gk_fused_leaky_relu_bwd_bf16": [P] * 5 + [I, I, F, F] + [I] * 5 + [P],
    "gk_upfirdn2d_bf16": [P, P] + [I] * 20 + [Taps, P],
    # xm, w (3, 3, Cin, Cout), its TF32 planes' scratch (2, 9, Cout, Cin),
    # demod, noise, noise batch stride, nw, bias, out, split scratch (or
    # NULL), tap splits, B, H, W, Cin, Cout, then the plan (the tile's
    # width, the ring's stages, the 128-pixel tiles), stream
    "gk_styled_conv3x3": [P, P, P, P, P, ctypes.c_longlong, P, P, P, P]
                         + [I] * 9 + [P],
    # xm, w (3, 3, Cin, Cout), its TF32 planes' scratch, demod, noise, noise
    # batch stride, nw, bias, scratch, out, B, H, W, Cin, Cout, the four 1-D
    # blur taps, then the plan (the tile's width, the ring's stages, a
    # class's tiles), stream
    "gk_styled_up_conv3x3": [P, P, P, P, P, ctypes.c_longlong, P, P, P, P,
                             I, I, I, I, I, F, F, F, F, I, I, I, P],
    # bf16 xm, w (3, 3, Cout, Cin), out; fp32 demod, noise, nw, bias, split
    # scratch: xm, w, demod, noise, noise batch stride, nw, bias, out,
    # scratch, tap splits, B, H, W, Cin, Cout, then the plan (the tile's
    # rows and width, the ring's stages, the pixel box tw, th, nb), stream
    "gk_styled_conv3x3_bf16": [P, P, P, P, ctypes.c_longlong, P, P, P, P]
                              + [I] * 12 + [P],
    # bf16 xm, w, out; fp32 demod, noise, nw, bias, T scratch: xm, w,
    # demod, noise, noise batch stride, nw, bias, scratch, out, B, H, W,
    # Cin, Cout, the four 1-D blur taps, then the plan (the tile's rows and
    # width, the ring's stages, a class's tiles), stream
    "gk_styled_up_conv3x3_bf16": [P, P, P, P, ctypes.c_longlong, P, P, P, P,
                                  I, I, I, I, I, F, F, F, F, I, I, I, I, P],
    # x, w (3, 3, Cin, Cout), s, demod, noise, noise batch stride, nw, bias,
    # out, the up body's T scratch (or NULL), splits, B, H, W, Cin, Cout,
    # up, the four 1-D blur taps, stream
    "gk_styled_conv3x3_narrow": [P] * 5 + [ctypes.c_longlong] + [P] * 4
                                + [I] * 7 + [F] * 4 + [P],
    # scores, r, c, q, u, part_m, part_s, B, K, niters, inv_eps,
    # rows per chunk, chunks, stream
    "gk_sinkhorn_knopp": [P] * 7 + [I, I, I, F, I, I, P],
    # x, alpha, intercept, out, B, C, S, W, V, the block (tw, tv), stream
    "gk_resample_rows": [P] * 4 + [I] * 7 + [P],
    # g, alpha, intercept, dx, B, C, S, W, V, stream
    "gk_resample_rows_t": [P] * 4 + [I] * 5 + [P],
    # their bf16 kernels (alpha and intercept float32), with their tiles:
    # (tw, tv) and (tw, ts) after B, C, S, W, V
    "gk_resample_rows_bf16": [P] * 4 + [I] * 7 + [P],
    "gk_resample_rows_t_bf16": [P] * 4 + [I] * 7 + [P],
}

_lib = None
_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    heads = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, heads


def _digest(files):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in files:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(srcs, out_path, log_path):
    """One nvcc per source, all in flight together, then one link."""
    nvcc = _nvcc()
    obj_dir = out_path + ".objs"
    os.makedirs(obj_dir, exist_ok=True)
    procs = []
    for src in srcs:
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(cmd[-3])
    if not failed:
        tmp = f"{out_path}.tmp{os.getpid()}"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", tmp] + [obj for _, obj, _ in procs]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + link.stdout)
        if link.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, out_path)
    with open(log_path, "w") as f:
        f.write("\n".join(log))
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(
            f"kernel build failed ({', '.join(failed)}); see {log_path}:\n"
            + "\n".join(log)[-4000:]
        )


def load():
    """The kernels' shared library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        srcs, heads = _sources()
        tag = _digest(srcs + heads)
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libganecdotes_kernels_{tag}.so")
        log_path = os.path.join(BUILD_DIR, f"build_{tag}.log")
        compiled = not os.path.exists(so)
        if compiled:
            _compile(srcs, so, log_path)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gk_error_string.argtypes = [ctypes.c_int]
        lib.gk_error_string.restype = ctypes.c_char_p
        BUILD_INFO.update(seconds=time.perf_counter() - t0, compiled=compiled,
                          library=so, log=log_path)
        _lib = lib
        return lib


def launch(kernel, entry, *args):
    """Call C entry ``entry`` of the library, raise on a CUDA error, count it
    (and, while a span records, credit it to the innermost open span)."""
    lib = _lib or load()
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        msg = lib.gk_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch: {msg}")
    LAUNCHES[kernel] += 1
    if tracing.OPEN:
        tracing.credit(kernel)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_of(t):
    """PyTorch's current stream on ``t``'s device, as an address (the raw
    handle: ``torch.cuda.current_stream`` builds a Stream object per call)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def ptr(t):
    """``t``'s address as an int (every signature declares it c_void_p)."""
    return t.data_ptr()


def kernel_dtype(kernel, t, name="x"):
    """``t``'s dtype where the kernels take it (``DTYPES``); raises naming
    the kernel otherwise (float16, float64, integers)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t)}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, the kernel takes "
                        "float32 or bfloat16")
    return t.dtype


def entry(name, dtype):
    """The C entry of ``name`` for element type ``dtype``."""
    return name + "_bf16" if dtype is torch.bfloat16 else name


def check_tensor(kernel, t, name, ndim=None, device=None, dtype=torch.float32):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (of
    ``ndim``)."""
    # the common case in one expression: the wrappers run this for every
    # argument of every launch, and at B = 1 their host time is the call's
    if (isinstance(t, torch.Tensor) and t.is_cuda and t.dtype is dtype
            and (device is None or t.device == device)
            and (ndim is None or t.dim() == ndim) and t.is_contiguous()
            and not t.data_ptr() % 16 and t.numel() < 2**31):
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel takes CUDA tensors")
    if device is not None and t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, this launch takes {dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    if t.numel() >= 2**31:
        raise ValueError(f"{kernel}: {name} has {t.numel()} elements, over 2**31")

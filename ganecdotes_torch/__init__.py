"""ganecdotes_torch — the PyTorch/CUDA port of ganecdotes_tpu for NVIDIA Hopper.

The JAX package ``ganecdotes_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Module paths and function names
mirror the JAX package so each counterpart is easy to find. Public functions
keep the JAX layouts: NHWC activations, HWIO conv weights, (in, out) linear
weights.

Numerics: the port computes in float32. ``resolve_device`` turns cuDNN's
TF32 convolutions off and keeps float32 matmuls at "highest" precision, so a
float32 convolution on the card is a float32 convolution (cuDNN would
otherwise run it in TF32 and keep only about three decimal digits).
"""

import os

import torch

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CONFIGS_DIR = os.path.join(PKG_DIR, "configs")
CHECKPOINT_DIR = os.path.join(ROOT_DIR, "checkpoints")
RESULTS_DIR = os.path.join(ROOT_DIR, "results")
# compiled kernels (ops/_build.py); listed in .gitignore
BUILD_DIR = os.path.join(ROOT_DIR, "build", "kernels")

__version__ = "0.1.0"


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller asks.

    With ``device=None`` and no CUDA device this raises: the port never
    carries on quietly on the CPU. ``device="cpu"`` runs every kernel's plain
    PyTorch version (as the CPU tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device


def compute_dtype(name, knob="compute_dtype"):
    """A config's compute type (its ``knob``: ``inference_dtype``,
    ``compute_dtype``): None, 'float32' or ``torch.float32`` give None (the
    default float32 path itself), 'bfloat16' or ``torch.bfloat16`` give
    ``torch.bfloat16``; anything else raises ``NotImplementedError``, as the
    JAX package does."""
    if name in (None, "float32", torch.float32):
        return None
    if name in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise NotImplementedError(f"{knob}={name!r}: expected None, 'float32' or 'bfloat16'")


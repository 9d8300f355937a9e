"""Operand rounding for the plain reference.

The reference computes in float32 with TF32 off. To stand in for a lower
precision (the control of a cell's comparison), every operand of a matmul or
convolution is first rounded to that format and the product is then
accumulated in float32, as a tensor core does:

- ``fp32``: no rounding;
- ``tf32``: 10 explicit mantissa bits, round to nearest even;
- ``bf16``: 7 explicit mantissa bits;
- ``fp8``: float8 e4m3 with one scale per tensor (its largest magnitude
  mapped to 448, the format's largest finite value).
"""

import torch

FORMATS = ("fp32", "tf32", "bf16", "fp8")
E4M3_MAX = 448.0


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x):
    amax = x.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


ROUND = {"tf32": _tf32, "bf16": _bf16, "fp8": _fp8}


def rounder(fmt):
    """The function that rounds a float32 tensor to ``fmt`` and back. Its
    gradient is the incoming gradient rounded the same way (the operand
    a backward matmul or convolution takes), to any order."""
    if fmt == "fp32":
        return lambda x: x
    if fmt not in ROUND:
        raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")
    fn = ROUND[fmt]

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return fn(x.detach())

        @staticmethod
        def backward(ctx, g):
            return Round.apply(g)

    return Round.apply

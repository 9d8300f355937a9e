"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

A float32 cell is held against the TF32 tensor-core rate: the card's
fastest rate on float32 operands, and no float32-accurate path runs faster.
"""

FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def flops_peak(dtype):
    return FLOPS[dtype or "float32"]

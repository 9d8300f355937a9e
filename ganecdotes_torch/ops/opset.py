"""The port's kernels and their plain versions, as two op sets.

``KERNELS`` holds the wrappers that launch the CUDA kernels on CUDA tensors
(and use the plain versions on CPU tensors). ``PLAIN`` holds the plain
PyTorch versions: the reference the kernels are held against on the card.
The generator and the SwAV step take one of the two; nothing chooses between
them at run time.
"""

from typing import Callable, NamedTuple

from ganecdotes_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_ref
from ganecdotes_torch.ops.modulated_conv import (
    styled_conv3x3,
    styled_conv3x3_ref,
    styled_up_conv3x3,
    styled_up_conv3x3_ref,
)
from ganecdotes_torch.ops.sinkhorn import sinkhorn_knopp, sinkhorn_knopp_ref
from ganecdotes_torch.ops.upfirdn2d import upfirdn2d, upfirdn2d_ref


class OpSet(NamedTuple):
    fused_leaky_relu: Callable
    upfirdn2d: Callable
    styled_conv3x3: Callable
    styled_up_conv3x3: Callable
    sinkhorn_knopp: Callable


KERNELS = OpSet(fused_leaky_relu, upfirdn2d, styled_conv3x3, styled_up_conv3x3,
                sinkhorn_knopp)
PLAIN = OpSet(fused_leaky_relu_ref, upfirdn2d_ref, styled_conv3x3_ref,
              styled_up_conv3x3_ref, sinkhorn_knopp_ref)

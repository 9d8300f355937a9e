"""serve.styledconv_roofline: the StyledConv kernels' share of their
roofline, in %. The least time of every StyledConv layer of the traced
requests (the larger of its useful operations at the cell type's peak and
its input, weight and output bytes at 3.35 TB/s; ``benchmark/flops``),
over the device time of the kernels whose names the patterns file
matches. Layer: the kernels (ops/modulated_conv.py -> csrc/styled_conv*.cu).

The time is the matched kernels' alone: the wrapper's own PyTorch passes
around them (the input's modulation, the weight's permute and cast) are
not in it. So the share is the kernels', not the whole layer's, and it is
not comparable across a change that moves work between the wrapper and
the kernels (a fusion of the modulation lowers it while the layer gets
faster); read ``serve.mfu_pct`` beside it there.
"""

from harness.peaks import HBM_BYTES_PER_S


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or not patterns or not outcome.records:
        return None
    busy = sum(d for name, _, d in tr.kernels
               if any(p.search(name) for p in patterns)) / 1e6
    if busy <= 0:
        return None
    layers = outcome.flops.styled_convs(outcome.config, outcome.batch)
    bound = sum(max(f / outcome.peak_flops, b / HBM_BYTES_PER_S)
                for _, f, b in layers)
    return 100.0 * bound * len(outcome.records) / busy

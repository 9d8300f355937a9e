"""serve.styledconv_layer_roofline: the StyledConv layers' share of their
roofline, in %: the bound ``serve.styledconv_roofline`` uses (each layer's
useful operations at the cell type's peak or its bytes at 3.35 TB/s, the
larger; ``benchmark/flops``) over the device time of the program's
``ops.styled_conv3x3`` and ``ops.styled_up_conv3x3`` spans, which hold the
whole layer: the wrapper's passes (the modulation, the weight's permute
and cast) and the kernels. Layer: the kernels (ops/modulated_conv.py)."""

from harness import program_spans
from harness.peaks import HBM_BYTES_PER_S

LAYERS = {"ops.styled_conv3x3", "ops.styled_up_conv3x3"}


def read(outcome, patterns):
    ms = program_spans.mean_ms(outcome, "serve.request", LAYERS)
    if not ms:
        return None
    layers = outcome.flops.styled_convs(outcome.config, outcome.batch)
    bound = sum(max(f / outcome.peak_flops, b / HBM_BYTES_PER_S)
                for _, f, b in layers)
    return 100.0 * bound / (ms / 1e3)

"""serve.top_level_roofline: the synthesis' top resolution level's share of
its roofline, in %. The least time of the level's layers, its up conv,
conv and to_rgb (each the larger of its useful operations at the cell
type's peak and its bytes at 3.35 TB/s; the flops module's ``level``),
over ``serve.top_level_ms``, the device time of its span ``synth.r<size>``.
The same work whichever variant of the StyledConv kernels runs it
(``ops/modulated_conv.py::variant``: at car512's Cout 64, the narrow fp32
kernel or the 3xTF32 loop at tile width 64).
Layer: the kernels (ops/modulated_conv.py, csrc/styled_conv*.cu)."""

from harness.peaks import HBM_BYTES_PER_S
from harness.registry import sibling

top_level_ms = sibling(__file__, "serve.top_level_ms").read


def read(outcome, patterns):
    level = getattr(outcome.flops, "level", None)
    ms = top_level_ms(outcome, patterns)
    if level is None or not ms:
        return None
    layers = level(outcome.config, outcome.batch, outcome.config["size"])
    bound = sum(max(f / outcome.peak_flops, b / HBM_BYTES_PER_S)
                for _, f, b in layers)
    return 100.0 * bound / (ms / 1e3)

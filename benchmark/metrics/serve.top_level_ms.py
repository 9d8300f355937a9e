"""serve.top_level_ms: device milliseconds a request in the program's span
of the synthesis' top resolution level, ``synth.r<size>`` (its up conv,
conv and to_rgb; ``models/stylegan2/generator.py``), the mean over the
traced window's requests. Layer: the kernels (ops/modulated_conv.py,
csrc/styled_conv*.cu)."""

from harness import program_spans


def read(outcome, patterns):
    name = f"synth.r{outcome.config['size']}"
    # nothing where the program has no such span
    return program_spans.mean_ms(outcome, "serve.request", {name}) or None

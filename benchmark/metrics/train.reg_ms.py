"""train.reg_ms: device milliseconds an iteration in the lazy
regularisers' spans, ``gan.r1`` and ``gan.ppl`` (one R1 and four PPL in a
window of 16 iterations), the mean over the traced window's iterations.
Layer: the GAN trainer (gan/train.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "gan.optimize", {"gan.r1", "gan.ppl"})

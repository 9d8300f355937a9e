"""train.g_step_ms: device milliseconds an iteration in the program's
``gan.g_step`` span, the mean over the traced window's iterations. Layer:
the GAN trainer (gan/train.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "gan.optimize", {"gan.g_step"})

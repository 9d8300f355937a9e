"""train.d_step_ms: device milliseconds an iteration in the program's
``gan.d_step`` span (the D step with its penalty and ADA), the mean over
the traced window's iterations. Layer: the GAN trainer (gan/train.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "gan.optimize", {"gan.d_step"})

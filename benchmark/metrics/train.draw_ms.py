"""train.draw_ms: host milliseconds an iteration in the program's
``gan.draw`` span (``draw_step_inputs``: the latents, noise maps and ADA
draws on the host, copied to the card), the mean over the traced window's
iterations. Layer: the GAN trainer (gan/train.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "gan.optimize", {"gan.draw"}, clock="host")

"""train.d_grad_ms: device milliseconds an iteration in the D step's
``gan.grad`` span (``torch.autograd.grad`` of the D loss: the penalty's
double backward and the recompute), the mean over the traced window's
iterations. Layer: the GAN trainer (gan/train.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "gan.optimize", {"gan.grad"},
                                 parent="gan.d_step")

"""serve.segment_ms: device milliseconds a request in the program's
``serve.segment`` span (the folded head, sample 0's projection and the
argmaxes; ``pipeline/serving.py``), the mean over the traced window's
requests. Layer: the server (pipeline/serving.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "serve.request", {"serve.segment"})

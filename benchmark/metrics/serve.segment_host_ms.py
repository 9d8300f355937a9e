"""serve.segment_host_ms: host milliseconds a request in the program's
``serve.segment`` span. Layer: the server (pipeline/serving.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "serve.request", {"serve.segment"},
                                 clock="host")

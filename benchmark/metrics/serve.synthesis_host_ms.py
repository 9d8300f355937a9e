"""serve.synthesis_host_ms: host milliseconds a request in the program's
``serve.synthesis`` span: the issue of its launches and any wait on the
card inside it. Layer: the server (pipeline/serving.py)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_ms(outcome, "serve.request", {"serve.synthesis"},
                                 clock="host")

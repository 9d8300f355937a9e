"""serve.fcn_tail_ms: device milliseconds a request in the program's
``seg.fcn_tail`` span (the FCN head's convs after the one folded into the
pyramid, with their activations; ``selfsup/embed.py::project_segment_fcn``),
the mean over the traced window's requests. Layer: the folded head
(selfsup/embed.py)."""

from harness import program_spans


def read(outcome, patterns):
    # nothing where the program has no such span
    return program_spans.mean_ms(outcome, "serve.request", {"seg.fcn_tail"}) or None

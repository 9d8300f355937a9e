"""serve.copy_out_ms: device milliseconds a request in the copies of the
outputs to the host (the image, the labels and z0 that the caller takes
with ``.cpu()``), from the device trace: the time of the operations the
patterns file matches over the traced requests. Layer: the server's
outputs (pipeline/serving.py returns them in the types it computes)."""


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or not patterns or not outcome.records:
        return None
    copy = sum(d for name, _, d in tr.kernels
               if any(p.search(name) for p in patterns))
    if copy <= 0:
        return None
    return copy / 1e3 / len(outcome.records)

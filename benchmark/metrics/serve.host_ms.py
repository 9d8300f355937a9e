"""serve.host_ms: host milliseconds from the call into the server until it
returns (before the outputs are copied to the host), the mean over the
traced window's requests. Layer: the server (pipeline/serving.py)."""


def read(outcome, patterns):
    recs = outcome.records
    if not recs:
        return None
    return sum(t1 - t0 for t0, t1, _ in recs) / len(recs) * 1e3

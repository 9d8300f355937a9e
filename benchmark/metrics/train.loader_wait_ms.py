"""train.loader_wait_ms: host milliseconds the loop waited in the native
loader's ``next`` for a batch, the mean over the traced window's
iterations. Layer: the data loader (runtime/)."""


def read(outcome, patterns):
    recs = outcome.records
    if not recs:
        return None
    return sum(t1 - t0 for _, t0, t1, _ in recs) / len(recs) * 1e3

"""Per-layer metrics read from the program's own spans and counters
(``ganecdotes_torch/utils/tracing.py``), not from the benchmark's ranges.

A traced run's profiler turns the program's recording on for exactly the
window, so after the run ``tracing.snapshot()`` holds the window's spans:
one root span a request (``serve.request``) or an iteration
(``gan.optimize``), their children, and the counters. The snapshot is read
once a run and kept on the outcome. A metric is a sum over the window's
spans divided by the number of its root spans, which has to be the number
of requests or iterations the window timed (``outcome.records``): where it
is not, or where the program has no span registry or recorded nothing,
the readers return None.
"""


def snapshot(outcome):
    """The program's ``tracing.snapshot()`` after the run (None where the
    program has no span registry), read once and kept on ``outcome``."""
    snap = getattr(outcome, "program_spans", None)
    if snap is None:
        try:
            from ganecdotes_torch.utils import tracing
        except ImportError:
            return None
        snap = outcome.program_spans = tracing.snapshot()
    return snap


def window(outcome, root):
    """(snapshot, n): the window's snapshot and its number of ``root``
    spans, or None where there are no spans or ``n`` is not the window's
    number of requests or iterations."""
    snap = snapshot(outcome)
    if snap is None or not snap.spans:
        return None
    n = sum(s.parent is None and s.name == root for s in snap.spans)
    if n == 0 or n != len(outcome.records):
        return None
    return snap, n


def mean_ms(outcome, root, names, clock="device", parent=None):
    """Milliseconds a ``root`` span (a request or an iteration) in the
    spans named in ``names`` (whose parent is named ``parent``, if given),
    on the device's clock or the host's (``clock``)."""
    got = window(outcome, root)
    if got is None:
        return None
    snap, n = got
    field = "device_ms" if clock == "device" else "host_ms"
    total = sum(getattr(s, field) for s in snap.spans if s.name in names
                and (parent is None or (s.parent is not None
                                        and snap.spans[s.parent].name == parent)))
    return total / n


def mean_counter(outcome, root, name):
    """Counter ``name``'s total a ``root`` span (None where it was never
    counted)."""
    got = window(outcome, root)
    if got is None or name not in got[0].counters:
        return None
    snap, n = got
    return snap.counters[name] / n

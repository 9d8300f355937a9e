"""Spans and counters of the port's layers: the one registry that the
server, the StyledConv wrappers, the GAN trainer, the SwAV step and the
loader record into, and that measuring code reads back.

    with tracing.span("serve.synthesis"):
        ...
    tracing.count("loader.starved", ms)

Recording is off by default. Then ``span`` is one flag check and returns a
shared null context: no ``record_function``, no CUDA event, no record.
Recording is on while a ``torch.profiler`` session records, and between
``start()`` and ``stop()``. A span then

- opens ``torch.profiler.record_function(name)``, so it lies in the
  profiler's trace on the profiler's own clock;
- records a pair of timing CUDA events on the current stream, from a pool,
  once the process has initialised CUDA (before that, and on the CPU, its
  device time is its host time);
- reads ``time.perf_counter()`` at entry and exit;
- keeps a record: name, parent span, id, host start and end, the events.

A span's ``id`` is its parent's unless given; a root span without one takes
a fresh one, so all the spans of one request or iteration share an id.
``count(name, n)`` adds to a counter of the innermost open span (to the
counters outside any span when none is open), and ``ops._build.launch``
credits each kernel launch to the innermost open span.

``snapshot()`` synchronises, resolves the events and returns a
``Snapshot``: every span's host and device ms, its self ms (the duration
less what its child spans cover), its launches and counters (its
descendants' included), and every counter's total. ``reset()`` forgets the
records; they are kept in memory until then.

Spans nest on one thread: the port opens them on the thread that calls it.
The registry is the process's, as the profiler is.
"""

import itertools
import time
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# the open spans, innermost last (tested by ``_build.launch``)
OPEN = []
_records = []  # every recorded span, in the order the spans opened
_outside = {}  # counters counted while no span was open
_pool = []  # timing CUDA events for reuse
_ids = itertools.count()
_on = False
_NULL = nullcontext()


class Span(NamedTuple):
    """One span of a ``Snapshot``. ``parent`` indexes ``Snapshot.spans``
    (None for a root); times in ms; ``launches`` {kernel: launches} and
    ``counters`` {name: total} inside the span, its descendants' included."""

    name: str
    id: int
    parent: Optional[int]
    host_ms: float
    device_ms: float
    self_host_ms: float
    self_device_ms: float
    launches: dict
    counters: dict


class Snapshot(NamedTuple):
    spans: list  # Span, in the order the spans opened
    counters: dict  # every counter's total, inside spans and outside any


def recording():
    """Whether spans record now: between ``start()`` and ``stop()``, or
    while a ``torch.profiler`` session records."""
    return _on or _profiler._is_profiler_enabled


def start():
    """Record spans until ``stop()``, with or without a profiler."""
    global _on
    _on = True


def stop():
    global _on
    _on = False


def span(name, id=None):
    """A context manager that records ``name`` while recording is on."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, id)


class _Span:
    """A recording span and, once entered, its record."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "e0", "e1", "launches",
                 "counters", "range")

    def __init__(self, name, id):
        self.name, self.id = name, id
        self.launches = self.counters = self.e0 = self.e1 = None

    def __enter__(self):
        parent = self.parent = OPEN[-1] if OPEN else None
        if self.id is None:
            self.id = parent.id if parent is not None else next(_ids)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            self.e0 = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
            self.e1 = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()
        _records.append(self)
        OPEN.append(self)

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self.e1 is not None:
            self.e1.record()
        OPEN.pop()
        self.range.__exit__(*exc)
        self.range = None
        return False


def count(name, n=1):
    """Add ``n`` to counter ``name`` of the innermost open span (of no span
    when none is open) while recording."""
    if OPEN:
        sp = OPEN[-1]
        if sp.counters is None:
            sp.counters = {}
        sp.counters[name] = sp.counters.get(name, 0) + n
    elif recording():
        _outside[name] = _outside.get(name, 0) + n


def credit(kernel):
    """One launch of ``kernel`` inside the innermost open span (call it
    only when ``OPEN`` is not empty)."""
    sp = OPEN[-1]
    if sp.launches is None:
        sp.launches = {}
    sp.launches[kernel] = sp.launches.get(kernel, 0) + 1


def _add(into, d):
    for k, v in d.items():
        into[k] = into.get(k, 0) + v


def snapshot():
    """Every recorded span and counter (see ``Snapshot``); synchronises the
    device where a span recorded events. Raises inside an open span."""
    if OPEN:
        raise RuntimeError(f"tracing.snapshot inside the open span {OPEN[-1].name!r}")
    recs = list(_records)
    if any(r.e0 is not None for r in recs):
        torch.cuda.synchronize()
    index = {id(r): i for i, r in enumerate(recs)}
    host = [(r.t1 - r.t0) * 1e3 for r in recs]
    dev = [h if r.e0 is None else r.e0.elapsed_time(r.e1) for r, h in zip(recs, host)]
    parent = [None if r.parent is None else index[id(r.parent)] for r in recs]
    child_host, child_dev = [0.0] * len(recs), [0.0] * len(recs)
    launches = [dict(r.launches or {}) for r in recs]
    counters = [dict(r.counters or {}) for r in recs]
    totals = dict(_outside)
    for r in recs:
        _add(totals, r.counters or {})
    for i in reversed(range(len(recs))):  # a child opened after its parent
        p = parent[i]
        if p is not None:
            child_host[p] += host[i]
            child_dev[p] += dev[i]
            _add(launches[p], launches[i])
            _add(counters[p], counters[i])
    spans = [Span(r.name, r.id, parent[i], host[i], dev[i], host[i] - child_host[i],
                  dev[i] - child_dev[i], launches[i], counters[i])
             for i, r in enumerate(recs)]
    return Snapshot(spans, totals)


def reset():
    """Forget every record and counter; the events go back to the pool."""
    if OPEN:
        raise RuntimeError(f"tracing.reset inside the open span {OPEN[-1].name!r}")
    for r in _records:
        if r.e0 is not None:
            _pool.extend((r.e0, r.e1))
    _records.clear()
    _outside.clear()

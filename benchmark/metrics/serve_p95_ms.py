"""serve_p95_ms: the 95th percentile of the latency of every request of
the window, from the call into the server until its outputs are on the
host."""


def read(outcome, patterns):
    return outcome.e2e.get("p95_ms")

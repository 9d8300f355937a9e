"""Faults planted under the timed path of the serving cells with a head
of several convs: the serving cells' faults (``faults/oneshot_server.py``),
which wrap the call into any server."""

from harness.registry import sibling

FAULTS = sibling(__file__, "oneshot_server").FAULTS

"""The control of the serving cells with a head of several convs: the
serving cells' control (``controls/oneshot_server.py``), which serves any
reference's request in the program's place."""

from harness.registry import sibling

Control = sibling(__file__, "oneshot_server").Control

"""setup_s: seconds from the start of the process until the window opens:
imports, the kernels' build or load, the weights, the program's own
set-up and the warm-up."""


def read(outcome, patterns):
    return outcome.e2e.get("setup_s")

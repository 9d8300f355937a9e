"""train.loader_starved_ms: milliseconds an iteration that the native
loader's ``next`` waited on an empty queue, its worker behind (the
program's ``loader.starved`` counter), the mean over the traced window's
iterations. Layer: the data loader (runtime/)."""

from harness import program_spans


def read(outcome, patterns):
    return program_spans.mean_counter(outcome, "gan.optimize", "loader.starved")

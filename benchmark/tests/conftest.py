"""The benchmark's CPU tests: ``pytest benchmark/`` from the repo's root.

They import the harness as ``run.py`` does (the benchmark's folder and the
repo's root on the path) and run on the CPU at tiny sizes, with the card's
look skipped where a test drives a whole run."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

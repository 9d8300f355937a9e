"""A whole run with the timed path broken underneath (the card's look
skipped, the tiny cell on the CPU) comes out not correct, for each fault a
serving cell can have (``faults/oneshot_server.py``): half of the batch
left out, and an answer altered where it is produced (an image, one
image's labels, the cluster map z0)."""

import time

import pytest

import tiny
from faults.oneshot_server import (
    half_batch,
    image_altered,
    labels_altered,
    z0_altered,
)
from harness import main


@pytest.mark.parametrize("dtype,limits", [
    ("float32", "ffhq256-serve-b32"), ("bfloat16", "ffhq256-serve-bf16-b64")])
@pytest.mark.parametrize("fault,number", [
    (half_batch, "image_gap"), (image_altered, "image_gap"),
    (labels_altered, "label_gap"), (z0_altered, "z0_gap")])
def test_a_broken_path_is_not_correct(tmp_path, fault, number, dtype, limits):
    root = tiny.make_root(tmp_path, limits_from=limits, dtype=dtype)
    line = main.execute(tiny.args(seed=2**31 + 21, seconds=0.3),
                        t_start=time.perf_counter(), root=root, device="cpu",
                        require_chip=False, wrap=fault)
    assert line["correct"] is False
    c = line["checks"][number]
    assert float(c["value"]) > c["limit"]

"""The plain reference against the program's plain path (the port on the
CPU runs every kernel's plain PyTorch version) at a tiny size, through a
whole run of the harness: float32 and bf16 come out correct, and their
numbers sit far inside the cells' limits."""

import time

import pytest

import tiny
from harness import main


@pytest.mark.parametrize("dtype,limits,scale", [
    ("float32", "ffhq256-serve-b32", 0.05),
    ("bfloat16", "ffhq256-serve-bf16-b64", 0.5),
])
def test_the_program_agrees_with_the_reference(tmp_path, dtype, limits, scale):
    root = tiny.make_root(tmp_path, limits_from=limits, dtype=dtype)
    line = main.execute(tiny.args(seed=2**31 + 3, seconds=0.3),
                        t_start=time.perf_counter(), root=root, device="cpu",
                        require_chip=False)
    assert line["correct"] is True
    for name, c in line["checks"].items():
        assert c["value"] <= scale * c["limit"], (name, c)


def test_the_same_seed_gives_the_same_inputs_and_weights():
    import torch

    from harness import weights
    from reference import stylegan2_swav as ref_mod

    shapes = ref_mod.weight_shapes(tiny.TINY)
    a = weights.make(shapes, tiny.TINY, 2**33 + 1, torch.device("cpu"))
    b = weights.make(shapes, tiny.TINY, 2**33 + 1, torch.device("cpu"))
    c = weights.make(shapes, tiny.TINY, 2**33 + 2, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["projection"], c["projection"])

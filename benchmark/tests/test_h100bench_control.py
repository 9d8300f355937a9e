"""The control at a size a test run holds: the plain reference in the
program's place, one precision below the configuration's (TF32 for the
float32 cell, fp8 for the bf16 cell), comes out not correct under the
cells' limits; in float32 and bf16 it comes out correct (the rounding
itself is sound). On the card the control runs at the cells' own size:
``python3 benchmark/control.py`` (README)."""

import pytest

import control
import tiny

SEEDS = [2**31 + 41, 2**31 + 42, 2**31 + 43]


@pytest.mark.parametrize("dtype,limits,fmt,correct", [
    ("float32", "ffhq256-serve-b32", "tf32", False),
    ("bfloat16", "ffhq256-serve-bf16-b64", "fp8", False),
    ("float32", "ffhq256-serve-b32", "fp32", True),
    ("bfloat16", "ffhq256-serve-bf16-b64", "bf16", True),
])
def test_the_control(tmp_path, dtype, limits, fmt, correct):
    root = tiny.make_root(tmp_path, limits_from=limits, dtype=dtype)
    res = control.run("tiny-serve", fmt, SEEDS, 0.2, root=root, device="cpu",
                      require_chip=False)
    assert [line["correct"] for _, line in res] == [correct] * len(SEEDS)

"""train.mfu_pct: the useful operations of the iterations completed in the
traced window (``benchmark/flops``, each iteration by the step kinds it
ran) over the window's length, as a share of the card's peak for the
cell's type (495 TFLOP/s for float32 in TF32, 989 for bf16), in %."""


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels or not outcome.records:
        return None
    work = sum(outcome.flops.iteration(outcome.config, it)["total"]
               for it, _, _, _ in outcome.records)
    return 100.0 * work / tr.window_s / outcome.peak_flops

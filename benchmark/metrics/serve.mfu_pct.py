"""serve.mfu_pct: the useful operations of the traced window's requests
(``benchmark/flops``, counted from the configuration's shapes) over the
window's length, as a share of the card's peak for the cell's type (495
TFLOP/s for float32 in TF32, 989 for bf16), in %."""


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or tr.window_s <= 0 or not tr.kernels or not outcome.records:
        return None
    work = outcome.flops.request(outcome.config, outcome.batch)["total"]
    return 100.0 * work * len(outcome.records) / tr.window_s / outcome.peak_flops

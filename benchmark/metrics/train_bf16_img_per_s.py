"""train_bf16_img_per_s: as train_img_per_s, for the bf16 training cells,
whose runs spread more than twice as wide as the float32 cell's and so
take a bound of their own."""


def read(outcome, patterns):
    return outcome.e2e.get("img_per_s")

"""serve_bf16_img_per_s: as serve_img_per_s, for the bf16 serving cells,
whose runs spread several times as wide and so take a bound of their
own."""


def read(outcome, patterns):
    return outcome.e2e.get("img_per_s")

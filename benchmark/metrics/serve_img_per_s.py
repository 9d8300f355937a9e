"""serve_img_per_s: images of every request of the window over the time
from the window's start to the end of its last request (float32 cells)."""


def read(outcome, patterns):
    return outcome.e2e.get("img_per_s")

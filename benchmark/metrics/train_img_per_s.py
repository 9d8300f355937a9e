"""train_img_per_s: the batch times the iterations completed in the window
over the time from its start to the end of the last one."""


def read(outcome, patterns):
    return outcome.e2e.get("img_per_s")

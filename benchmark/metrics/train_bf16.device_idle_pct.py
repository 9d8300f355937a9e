"""train_bf16.device_idle_pct: train.device_idle_pct in the bf16 training
cells, whose end-to-end metric is train_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "train.device_idle_pct"
read = sibling(__file__, SIBLING).read

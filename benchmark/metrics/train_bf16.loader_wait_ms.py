"""train_bf16.loader_wait_ms: train.loader_wait_ms in the bf16 training
cells, whose end-to-end metric is train_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "train.loader_wait_ms"
read = sibling(__file__, SIBLING).read

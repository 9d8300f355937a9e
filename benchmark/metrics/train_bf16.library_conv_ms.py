"""train_bf16.library_conv_ms: train.library_conv_ms in the bf16 training
cells, whose end-to-end metric is train_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "train.library_conv_ms"
read = sibling(__file__, SIBLING).read

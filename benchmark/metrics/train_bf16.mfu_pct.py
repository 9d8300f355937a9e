"""train_bf16.mfu_pct: train.mfu_pct in the bf16 training cells, whose
end-to-end metric is train_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "train.mfu_pct"
read = sibling(__file__, SIBLING).read

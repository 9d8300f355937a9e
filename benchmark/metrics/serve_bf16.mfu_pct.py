"""serve_bf16.mfu_pct: serve.mfu_pct in the bf16 serving cells, whose
end-to-end metric is serve_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "serve.mfu_pct"
read = sibling(__file__, SIBLING).read

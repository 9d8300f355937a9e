"""serve_bf16.device_idle_pct: serve.device_idle_pct in the bf16 serving
cells, whose end-to-end metric is serve_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "serve.device_idle_pct"
read = sibling(__file__, SIBLING).read

"""serve_bf16.host_ms: serve.host_ms in the bf16 serving cells, whose
end-to-end metric is serve_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "serve.host_ms"
read = sibling(__file__, SIBLING).read

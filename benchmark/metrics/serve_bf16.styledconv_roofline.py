"""serve_bf16.styledconv_roofline: serve.styledconv_roofline in the bf16
serving cells, whose end-to-end metric is serve_bf16_img_per_s."""

from harness.registry import sibling

SIBLING = "serve.styledconv_roofline"
read = sibling(__file__, SIBLING).read

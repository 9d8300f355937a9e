"""Useful work of one hfc_with_swav request with an FCN head of several
convs (the XS head), from the configuration's shapes alone, counted as
``stylegan2_swav_serve`` counts the request with the head of one conv
(mapping, modulation, synthesis convs, to_rgb, sample 0's projection), and
the head as the served form computes it:

- its first conv folded into the pyramid: exactly the fold of a one-conv
  head as wide as that conv (``stylegan2_swav_serve.folded_head`` with
  ``head_out`` the first width);
- the tail: each further 3x3 conv, 2 * 9 * Cin * Cout an output pixel at
  the image size (its dilation changes no count).

``level(cfg, batch, res)`` gives the work of one resolution level of the
synthesis (its up conv, conv and to_rgb) with its bytes, for the level's
roofline.
"""

import math

from flops import stylegan2_swav_serve as base

channel_map = base.channel_map
levels = base.levels
styled_convs = base.styled_convs


def _first_conv_cfg(cfg):
    seg = cfg["segmentor"]
    return dict(cfg, segmentor=dict(seg, seg_size="XXS",
                                    head_out=seg["head_widths"][0]))


def head_tail(cfg):
    """Operations of the head's convs after the first, for one image."""
    seg = cfg["segmentor"]
    widths = list(seg["head_widths"]) + [seg["head_out"]]
    px = cfg["size"] * cfg["size"]
    return sum(2 * 9 * cin * cout * px for cin, cout in zip(widths[:-1], widths[1:]))


def folded_head(cfg):
    """Operations of the folded head for one image: the folded first conv
    and the tail."""
    return base.folded_head(_first_conv_cfg(cfg)) + head_tail(cfg)


def request(cfg, batch):
    """{part: operations} of one request of ``batch`` z, and ``total``."""
    parts = base.request(_first_conv_cfg(cfg), batch)
    parts["folded_head"] = folded_head(cfg) * batch
    parts["total"] = sum(v for k, v in parts.items() if k != "total")
    return parts


def level(cfg, batch, res):
    """[(name, operations, bytes)] of resolution level ``res`` of a request
    of ``batch``: its StyledConvs (``styled_convs``) and its to_rgb (2 *
    Cin * 3 operations a pixel; its input, weight, output and the skip it
    upsamples, each read or written once, at the synthesis' element size).
    The modulation matmuls and the skip's blur are not counted."""
    ch = channel_map(cfg)
    es = base.ESIZE[cfg.get("inference_dtype") or "float32"]
    if res == 4:
        names, rgb = {"conv1"}, "to_rgb1"
    else:
        k = int(math.log2(res)) - 3
        names, rgb = {f"convs.{2 * k}", f"convs.{2 * k + 1}"}, f"to_rgbs.{k}"
    out = [c for c in styled_convs(cfg, batch) if c[0] in names]
    c, px = ch[res], res * res
    skip = 0 if res == 4 else batch * px // 4 * 3
    out.append((rgb, 2 * c * 3 * px * batch,
                es * (batch * px * c + c * 3 + batch * px * 3 + skip)))
    return out

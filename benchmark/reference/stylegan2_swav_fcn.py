"""Plain reference of the hfc_with_swav request with a head of several
convs: StyleGAN2 (config-f, rosinality's layout) mapping and synthesis, the
linear SwAV projection of the nearest-upsampled feature pyramid, and an
FCN head (XS: conv dilation 1 -> LeakyReLU -> conv dilation 2 -> LeakyReLU
-> conv dilation 1), then the argmaxes.

Everything but the embedding and the head is ``reference.stylegan2_swav``'s
(plain float32 PyTorch, NCHW, TF32 off in cuBLAS and cuDNN, no import of
the program). The head's widths and dilations are read from the
configuration (``segmentor.head_widths``, ``head_dilations``,
``head_out``), not from the program's tables; its LeakyReLU has slope 0.2,
as ganecdotes' OneShotSegmentor (swav_clustering.py:697-758).

Departures from the published description, none of which changes a
number the reference computes in float32:

- only the maps inside ``hlen`` are upsampled and concatenated (the
  published form upsamples every map and cuts the concat at ``hlen``): the
  same matrix, without the 512^2 maps past the cut, so that ``check_rows``
  4 fits on the card;
- a control's operand rounding (``precision.rounder``) is applied to each
  map before its nearest upsample, not to the concat: the same values for
  the element-wise formats (tf32, bf16), where rounding the 22 GB concat
  would take several times its size; fp8's one scale per tensor becomes
  one a map.
"""

import torch
import torch.nn.functional as F

from reference import stylegan2_swav

LRELU_SLOPE = 0.2


def head_layers(cfg):
    """[(cin, cout, dilation)] of the head's convs, first to last."""
    seg = cfg["segmentor"]
    widths = [seg["nclasses"]] + list(seg["head_widths"]) + [seg["head_out"]]
    return list(zip(widths[:-1], widths[1:], seg["head_dilations"]))


def weight_shapes(cfg):
    """``stylegan2_swav.weight_shapes`` with the one-conv head replaced by
    the head's layers, ``head.<i>.weight`` (3, 3, cin, cout), HWIO, normal /
    sqrt(fan in), and ``head.<i>.bias``, small."""
    shapes = stylegan2_swav.weight_shapes(cfg)
    del shapes["head.weight"], shapes["head.bias"]
    for i, (cin, cout, _) in enumerate(head_layers(cfg)):
        shapes[f"head.{i}.weight"] = ((3, 3, cin, cout), "fan_in")
        shapes[f"head.{i}.bias"] = ((cout,), "small")
    return shapes


class Reference(stylegan2_swav.Reference):
    """The request as the configuration defines it, on ``device``."""

    def embedding(self, feats):
        """The maps inside hlen, nearest-upsampled to the image size and
        concatenated (the last one cut at hlen), times the projection:
        (B, nclasses, H, W)."""
        size = self.cfg["size"]
        hlen = self.cfg["segmentor"]["hlen"]
        cat = feats[0].new_empty((feats[0].shape[0], hlen, size, size))
        off = 0
        for f in feats:
            use = min(f.shape[1], hlen - off)
            if use <= 0:
                break
            cat[:, off : off + use] = F.interpolate(
                self.q(f[:, :use]), size=(size, size), mode="nearest")
            off += use
        return torch.einsum("bchw,cn->bnhw", cat, self.q(self.w["projection"]))

    def head(self, emb):
        x = emb
        for i, (_, _, d) in enumerate(head_layers(self.cfg)):
            if i:
                x = F.leaky_relu(x, LRELU_SLOPE)
            wt = self.w[f"head.{i}.weight"].permute(3, 2, 0, 1)
            x = (F.conv2d(self.q(x), self.q(wt), padding=d, dilation=d)
                 + self.w[f"head.{i}.bias"][None, :, None, None])
        return x

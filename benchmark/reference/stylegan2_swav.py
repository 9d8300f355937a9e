"""Plain reference of the hfc_with_swav request: StyleGAN2 (config-f layout
of rosinality's stylegan2-pytorch, Karras et al. 2020) mapping and
synthesis, the linear SwAV projection of the feature pyramid with nearest
interpolation, the XXS FCN head and the argmaxes.

Written from the published architecture in plain float32 PyTorch, NCHW,
with no kernel, no folding and no batching tricks: the modulated convs run
rosinality's unfused form (x * s, conv, * demod), the up convs a stride-2
transposed conv and then the [1, 3, 3, 1] blur, the projection a matmul
over the explicit upsampled concat, and the head a 3x3 convolution over the
(H, W, nclasses) embedding. It imports nothing of the program.

The weights are the benchmark's, keyed as ``benchmark/systems`` hands them
to the program: HWIO conv weights, (in, out) linear weights, NHWC noise
maps. ``fmt`` rounds every operand of a matmul or convolution
(``precision.rounder``): ``fp32`` is the reference, the others its
controls.
"""

import torch
import torch.nn.functional as F

from reference.precision import rounder
from reference.stylegan2 import Generator, generator_shapes


def weight_shapes(cfg):
    """{name: (shape, kind)} of every weight of the request, in order: the
    generator's (``stylegan2.generator_shapes``; biases and noise strengths
    ``small``, modulation biases around 1), the projection and the head
    (``fan_in``: normal / sqrt(fan in))."""
    shapes = generator_shapes(cfg)
    seg = cfg["segmentor"]
    shapes["projection"] = ((seg["hlen"], seg["nclasses"]), "fan_in")
    shapes["head.weight"] = ((3, 3, seg["nclasses"], seg["head_out"]), "fan_in")
    shapes["head.bias"] = ((seg["head_out"],), "small")
    return shapes


class Reference:
    """The request as the configuration defines it, on ``device``."""

    def __init__(self, cfg, weights, device, fmt="fp32"):
        # float32 means float32: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.w = {k: v.to(device=device, dtype=torch.float32)
                  for k, v in weights.items()}
        self.device = device
        self.q = rounder(fmt)
        self.gen = Generator(cfg, self.w, self.q)

    def mean_latent(self, z):
        return self.gen.mapping(z.to(self.device)).mean(dim=0, keepdim=True)

    # -- projection and head -----------------------------------------------

    def embedding(self, feats):
        """The concat of the maps, nearest-upsampled to the image size and
        cut to hlen channels, times the projection: (B, nclasses, H, W)."""
        size = self.cfg["size"]
        hlen = self.cfg["segmentor"]["hlen"]
        cat = torch.cat([F.interpolate(f, size=(size, size), mode="nearest")
                         for f in feats], dim=1)[:, :hlen]
        return torch.einsum("bchw,cn->bnhw", self.q(cat),
                            self.q(self.w["projection"]))

    def head(self, emb):
        wt = self.w["head.weight"].permute(3, 2, 0, 1)
        return (F.conv2d(self.q(emb), self.q(wt), padding=1)
                + self.w["head.bias"][None, :, None, None])

    def request(self, z, mean_w, rows=1):
        """(image (B, H, W, 3), logits (B, H, W, head_out), embedding of
        sample 0 (H, W, nclasses)) of a request of z, ``rows`` images at a
        time."""
        trunc = self.cfg["truncation"]
        imgs, logits, emb0 = [], [], None
        for i in range(0, z.shape[0], rows):
            w = self.gen.mapping(z[i : i + rows].to(self.device))
            w = mean_w + trunc * (w - mean_w)
            latent = w[:, None, :].expand(-1, self.gen.n_latent, -1)
            img, feats = self.gen.synthesis(latent)
            emb = self.embedding(feats)
            del feats
            if i == 0:
                emb0 = emb[0].permute(1, 2, 0)
            imgs.append(img.permute(0, 2, 3, 1))
            logits.append(self.head(emb).permute(0, 2, 3, 1))
            del emb
        return torch.cat(imgs), torch.cat(logits), emb0

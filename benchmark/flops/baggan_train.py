"""Useful work of one BagGAN-HQ training iteration, from the configuration's
shapes alone.

A forward pass F of a net is its matmul and convolution operations (2 per
multiply-add): for G the mapping, the modulation and demodulation matmuls,
the synthesis convs (per output pixel; the up convs per input pixel) and
to_rgb, as ``stylegan2_swav_serve`` counts them; for D the 1x1 input conv,
each residual block's 3x3 conv, its blurred stride-2 3x3 conv (per output
pixel) and 1x1 skip, the final conv (with the minibatch-deviation channel)
and the two linear layers. Blurs, ADA and elementwise work are not
counted. A backward pass is 2F (the gradients of the inputs and of the
weights); a gradient of a gradient (the penalties) costs F for the forward,
F for the first gradient (inputs only) and 4F for the backward through
both: 6F. The recompute of checkpointed activations is not counted.

- D step: G forward + D forward and backward
  on the fake and the real batch (2 x 3 F_D) + the WGAN-GP penalty (6 F_D);
- G step: G forward and backward (3 F_G) + D forward and its input
  gradient (2 F_D);
- R1 (every ``d_reg_every``): 6 F_D;
- PPL (every ``g_reg_every``, on batch / ``path_batch_shrink``): 6 F_G.
"""

import math

from flops.stylegan2_swav_serve import request


def channel_map(m):
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


def generator(cfg):
    """F_G of one image: the serving count without the head."""
    parts = request(dict(cfg, segmentor={"hlen": 0, "nclasses": 0,
                                         "head_out": 0, "seg_size": "XXS"}), 1)
    return (parts["mapping"] + parts["modulation"] + parts["synthesis_convs"]
            + parts["to_rgb"])


def discriminator(cfg):
    """F_D of one image."""
    s = cfg["size"]
    ch = channel_map(cfg["channel_multiplier"])
    flops = 2 * cfg["num_channels"] * ch[s] * s * s
    cin = ch[s]
    for i in range(int(math.log2(s)), 2, -1):
        r, cout = 2 ** i, ch[2 ** (i - 1)]
        flops += 2 * 9 * cin * cin * r * r  # conv1
        flops += 2 * 9 * cin * cout * (r // 2) ** 2  # conv2, stride 2
        flops += 2 * cin * cout * (r // 2) ** 2  # skip, stride 2
        cin = cout
    c4 = ch[4]
    flops += 2 * 9 * (c4 + 1) * c4 * 16 + 2 * c4 * 16 * c4 + 2 * c4
    return flops


def iteration(cfg, it):
    """{step kind: operations} of iteration ``it`` and ``total``."""
    b = cfg["batch_size"]
    f_g, f_d = generator(cfg), discriminator(cfg)
    work = {"d": b * (f_g + 12 * f_d), "g": b * (3 * f_g + 2 * f_d)}
    if it % cfg["d_reg_every"] == 0:
        work["r1"] = b * 6 * f_d
    if it % cfg["g_reg_every"] == 0:
        work["ppl"] = max(1, b // cfg["path_batch_shrink"]) * 6 * f_g
    work["total"] = sum(work.values())
    return work

"""StyleGAN2 discriminator: ResBlock downsample stack + minibatch stddev
(port of ganecdotes_tpu/models/stylegan2/discriminator.py), NHWC.

The module tree mirrors the JAX parameter pytree key for key ("conv_in",
"blocks.i.conv1/conv2/skip", "final_conv", "final_lin1", "final_lin2"), so
``convert.from_jax_discriminator_params`` is a plain load. Every blur goes
through ``ops.upfirdn2d`` and every biased activation through
``ops.fused_leaky_relu``, where ``ops`` is ``KERNELS`` (CUDA kernels, as
autograd Functions that R1 and WGAN-GP differentiate twice) or ``PLAIN``.
The stride-2 convs and the 1x1 skips are ``F.conv2d``. ``DiscriminatorQ``
is BagGAN's InfoGAN variant (``discriminator_forward_q``), its tree the JAX
Q tree's ("conv_in", "blocks_adv", "d", "q_cat", "q_cont").
"""

import copy
import math

import torch
import torch.nn as nn

from ganecdotes_torch.models.stylegan2.generator import channel_map
from ganecdotes_torch.nn.layers import (
    EqualConv2d,
    EqualLinear,
    conv2d_nhwc,
    leaky_relu,
)
from ganecdotes_torch.ops.opset import KERNELS
from ganecdotes_torch.ops.upfirdn2d import blur_2d
from ganecdotes_torch.parallel.mesh import all_gather, shard_batch


def conv_layer_apply(p, x, downsample=False, activate=True,
                     blur_kernel=(1, 3, 3, 1), ops=KERNELS):
    """ConvLayer semantics (ref model.py:651-697): optional blur + stride-2
    conv, equalized weight, fused bias + leaky-ReLU."""
    kh = p.weight.shape[0]
    w = p.scaled_weight()
    if downsample:
        pk = len(blur_kernel) - 2 + (kh - 1)
        x = blur_2d(x, blur_kernel, pad=((pk + 1) // 2, pk // 2),
                    impl=ops.upfirdn2d)
        out = conv2d_nhwc(x, w, stride=2, padding=0)
    else:
        out = conv2d_nhwc(x, w, stride=1, padding=kh // 2)
    # the NHWC conv output is a channels-last view; the kernels take it
    # contiguous
    out = out.contiguous()
    if activate:
        if p.bias is not None:
            return ops.fused_leaky_relu(out, p.bias)
        return leaky_relu(out) * math.sqrt(2)
    if p.bias is not None:
        out = out + p.bias.to(out.dtype)
    return out


class ResBlock(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.conv1 = EqualConv2d(in_ch, in_ch, 3, generator=generator)
        self.conv2 = EqualConv2d(in_ch, out_ch, 3, generator=generator)
        self.skip = EqualConv2d(in_ch, out_ch, 1, bias=False, generator=generator)

    def forward(self, x, blur_kernel=(1, 3, 3, 1), ops=KERNELS):
        out = conv_layer_apply(self.conv1, x, blur_kernel=blur_kernel, ops=ops)
        out = conv_layer_apply(self.conv2, out, downsample=True,
                               blur_kernel=blur_kernel, ops=ops)
        skip = conv_layer_apply(self.skip, x, downsample=True, activate=False,
                                blur_kernel=blur_kernel, ops=ops)
        return (out + skip) / math.sqrt(2)


def discriminator_meta(size, blur_kernel=(1, 3, 3, 1)):
    """Static architecture record."""
    return {"size": size, "stddev_group": 4, "stddev_feat": 1,
            "blur_kernel": tuple(blur_kernel)}


class Discriminator(nn.Module):
    """StyleGAN2 discriminator initialised from a ``torch.Generator`` on the
    CPU (as JAX ``init_discriminator``: N(0, 1) weights, zero biases); move
    it with ``.to(device)``."""

    def __init__(self, size, channel_multiplier=2, in_channels=3,
                 blur_kernel=(1, 3, 3, 1), res2chlmap=None, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        g = generator
        self.meta = discriminator_meta(size, blur_kernel)
        channels = channel_map(channel_multiplier, res2chlmap)
        log_size = int(math.log2(size))
        self.conv_in = EqualConv2d(in_channels, channels[size], 1, generator=g)
        self.blocks = nn.ModuleList()
        in_ch = channels[size]
        for i in range(log_size, 2, -1):
            out_ch = channels[2 ** (i - 1)]
            self.blocks.append(ResBlock(in_ch, out_ch, g))
            in_ch = out_ch
        self.final_conv = EqualConv2d(channels[4] + 1, channels[4], 3, generator=g)
        self.final_lin1 = EqualLinear(channels[4] * 4 * 4, channels[4], generator=g)
        self.final_lin2 = EqualLinear(channels[4], 1, generator=g)

    def forward(self, x, ops=KERNELS):
        return discriminator_forward(self, x, ops)


def minibatch_stddev(x, group_size=4, num_new_features=1, mesh=None):
    """Minibatch standard-deviation statistic (ref model.py:763-772), NHWC.

    The groups are strided over the batch (sample j with j + B/g, j + 2B/g,
    ...). Under a data-parallel ``mesh`` the statistic is the global
    batch's, as the JAX package's sharded program computes it: the ranks'
    inputs are gathered (differentiably), and each rank keeps its rows."""
    local = x
    if mesh is not None and mesh.size > 1:
        x = all_gather(mesh, x)
    b, h, w, c = x.shape
    group = min(b, group_size)
    y = x.reshape(group, -1, h, w, num_new_features, c // num_new_features)
    var = y.to(torch.float32).var(dim=0, unbiased=False)
    stddev = torch.sqrt(var + 1e-8)
    stddev = stddev.mean(dim=(1, 2, 4), keepdim=True).squeeze(4)  # (b/g,1,1,1)
    stddev = stddev.repeat(group, h, w, 1).to(x.dtype)
    if local is not x:
        stddev = shard_batch(mesh, stddev)
    return torch.cat([local, stddev], dim=-1)


def discriminator_forward(d, x, ops=KERNELS, mesh=None):
    """x: (B, H, W, 3) -> logits (B, 1); ``mesh``: the minibatch statistic
    over the data-parallel global batch."""
    bk = d.meta["blur_kernel"]
    out = conv_layer_apply(d.conv_in, x, blur_kernel=bk, ops=ops)
    for blk in d.blocks:
        out = blk(out, blur_kernel=bk, ops=ops)
    out = minibatch_stddev(out, d.meta["stddev_group"], d.meta["stddev_feat"],
                           mesh)
    out = conv_layer_apply(d.final_conv, out, blur_kernel=bk, ops=ops)
    b = out.shape[0]
    # torch's NCHW flatten order, so converted weights stay valid
    out = out.permute(0, 3, 1, 2).reshape(b, -1)
    out = d.final_lin1(out, activation="fused_lrelu", act=ops.fused_leaky_relu)
    return d.final_lin2(out)


# ---------------------------------------------------------------------------
# InfoGAN variant (BagGAN's `with_q` discriminator)
# ---------------------------------------------------------------------------


class QHead(nn.Module):
    """One head of ``DiscriminatorQ``: its own copies of the trunk's last
    ResBlocks, then stddev, final conv and a 2-layer equalized MLP."""

    def __init__(self, blocks, final_conv, lin1, lin2):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = final_conv
        self.lin1 = lin1
        self.lin2 = lin2


class DiscriminatorQ(nn.Module):
    """Discriminator with InfoGAN Q heads (ref models/baggan/models.py
    :393-498; JAX ``init_discriminator_q``). The trunk's last ``q_layers``
    ResBlocks and the stddev / conv / MLP tail are copied per head: the
    adversarial head ``d`` (the base discriminator's MLP), the categorical
    head ``q_cat`` (``n_cat_c * n_classes`` outputs, softmax) and the
    continuous head ``q_cont`` (``n_cont_c * 2``, tanh); a head with no
    codes is None. Initialised from a ``torch.Generator`` on the CPU."""

    def __init__(self, size, q_layers, n_cat_c, n_classes, n_cont_c,
                 channel_multiplier=2, in_channels=3, blur_kernel=(1, 3, 3, 1),
                 res2chlmap=None, generator=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        base = Discriminator(size, channel_multiplier, in_channels, blur_kernel,
                             res2chlmap, generator)
        n_blocks = len(base.blocks)
        q_layers = min(q_layers, n_blocks)
        c4 = channel_map(channel_multiplier, res2chlmap)[4]
        self.meta = dict(base.meta, q_layers=q_layers, n_cat_c=n_cat_c,
                         n_classes=n_classes, n_cont_c=n_cont_c)
        self.conv_in = base.conv_in
        self.blocks_adv = nn.ModuleList(base.blocks[:n_blocks - q_layers])

        def tail():
            return ([copy.deepcopy(b) for b in base.blocks[n_blocks - q_layers:]],
                    copy.deepcopy(base.final_conv))

        self.d = QHead(*tail(), base.final_lin1, base.final_lin2)
        self.q_cat = self.q_cont = None
        if n_cat_c > 0:
            self.q_cat = QHead(*tail(), EqualLinear(c4 * 16, c4, generator=generator),
                               EqualLinear(c4, n_cat_c * n_classes, generator=generator))
        if n_cont_c > 0:
            self.q_cont = QHead(*tail(), EqualLinear(c4 * 16, c4, generator=generator),
                                EqualLinear(c4, n_cont_c * 2, generator=generator))

    def forward(self, x, ops=KERNELS):
        return discriminator_forward_q(self, x, ops)


def _head_apply(head, meta, x, out_act=None, ops=KERNELS):
    bk = meta["blur_kernel"]
    out = x
    for blk in head.blocks:
        out = blk(out, blur_kernel=bk, ops=ops)
    out = minibatch_stddev(out, meta["stddev_group"], meta["stddev_feat"])
    out = conv_layer_apply(head.final_conv, out, blur_kernel=bk, ops=ops)
    b = out.shape[0]
    out = out.permute(0, 3, 1, 2).reshape(b, -1)
    out = head.lin1(out, activation="fused_lrelu", act=ops.fused_leaky_relu)
    out = head.lin2(out)
    if out_act == "softmax":
        out = torch.softmax(out, dim=-1)
    elif out_act == "tanh":
        out = torch.tanh(out)
    return out


def discriminator_forward_q(d, x, ops=KERNELS):
    """(B, H, W, C) -> (d_logits, q_cat or None, q_cont or None): the shared
    adversarial trunk, then each head's own tail (ref models.py:500-574)."""
    bk = d.meta["blur_kernel"]
    out = conv_layer_apply(d.conv_in, x, blur_kernel=bk, ops=ops)
    for blk in d.blocks_adv:
        out = blk(out, blur_kernel=bk, ops=ops)
    logits = _head_apply(d.d, d.meta, out, ops=ops)
    q_cat = None if d.q_cat is None else _head_apply(d.q_cat, d.meta, out, "softmax", ops)
    q_cont = None if d.q_cont is None else _head_apply(d.q_cont, d.meta, out, "tanh", ops)
    return logits, q_cat, q_cont

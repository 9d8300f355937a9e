"""Useful work of one hfc_with_swav request, from the configuration's
shapes alone (never from what the program launches).

Counted as the served form defines the model's work:

- the mapping: ``n_mlp`` matmuls of style x style a latent;
- the modulation matmuls (style -> Cin) of every StyledConv and to_rgb, and
  each StyledConv's demodulation (s**2 times the squared weight summed
  over its taps: Cin x Cout an image);
- the synthesis convs: 2 * 9 * Cin * Cout an output pixel; the up convs
  2 * 9 * Cin * Cout an input pixel (the transposed conv's taps that see
  data); the blurs are not counted;
- to_rgb: 2 * Cin * 3 a pixel;
- the folded head: the first 3x3 conv of the head folded into the pyramid,
  as the served form computes it (full-resolution levels conv the folded
  weights; levels at or below a quarter of the image are projected, summed
  and meet one polyphase conv there; the levels between take their own
  polyphase conv with the folded weights, or the projected form where that
  costs less);
- sample 0's projection, level by level at each level's resolution.

Bytes are each StyledConv's input, weight and output, each read or written
once, at the synthesis' element size. Everything is a multiply-add pair
(2 operations).
"""

import math

ESIZE = {"float32": 4, "bfloat16": 2}


def channel_map(cfg):
    if cfg.get("res2chlmap"):
        return {int(k): int(v) for k, v in cfg["res2chlmap"].items()}
    m = cfg["channel_multiplier"]
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


def styled_convs(cfg, batch):
    """[(name, flops, bytes)] of every StyledConv of a request of ``batch``."""
    ch = channel_map(cfg)
    es = ESIZE[cfg.get("inference_dtype") or "float32"]
    out = []

    def conv(name, cin, cout, r_in, up):
        r_out = 2 * r_in if up else r_in
        px = r_in * r_in  # up: per input pixel; else in = out
        flops = 2 * 9 * cin * cout * px * batch
        nbytes = es * (batch * r_in * r_in * cin + 9 * cin * cout
                       + batch * r_out * r_out * cout)
        out.append((name, flops, nbytes))

    conv("conv1", ch[4], ch[4], 4, False)
    cin = ch[4]
    for k, res in enumerate(2 ** j for j in range(3, int(math.log2(cfg["size"])) + 1)):
        conv(f"convs.{2 * k}", cin, ch[res], res // 2, True)
        conv(f"convs.{2 * k + 1}", ch[res], ch[res], res, False)
        cin = ch[res]
    return out


def levels(cfg):
    """(resolution, channels) of each feature map, in pyramid order."""
    ch = channel_map(cfg)
    out = [(4, ch[4])]
    for j in range(3, int(math.log2(cfg["size"])) + 1):
        out += [(2 ** j, ch[2 ** j])] * 2
    return out


def _used(cfg):
    """(resolution, channels used) of each level under the hlen cut."""
    left = cfg["segmentor"]["hlen"]
    used = []
    for r, c in levels(cfg):
        u = max(0, min(c, left))
        left -= u
        if u:
            used.append((r, u))
    return used


def folded_head(cfg):
    """Operations of the folded head for one image (XXS: one 3x3 conv)."""
    seg = cfg["segmentor"]
    if seg["seg_size"] != "XXS":
        raise NotImplementedError("the folded head is counted for XXS only")
    h = cfg["size"]
    d, co = seg["nclasses"], seg["head_out"]
    cutoff = h // 4
    flops = 0
    hi = {}
    for r, u in _used(cfg):
        if r == h:
            flops += 2 * 9 * u * co * r * r
        elif r > cutoff:
            hi.setdefault(r, []).append(u)
        else:
            flops += 2 * u * d * r * r  # projected at its resolution
    low = any(r <= cutoff for r, _ in _used(cfg))
    for r, us in hi.items():
        f = h // r
        fold = sum(9 * u * f * f * co for u in us)
        proj = sum(u * d for u in us) + 9 * d * f * f * co
        if fold > proj:
            # projected, then one polyphase conv of its own at r
            flops += sum(2 * u * d * r * r for u in us)
            flops += 2 * 9 * d * f * f * co * r * r
        else:
            flops += sum(2 * 9 * u * f * f * co * r * r for u in us)
    if low:
        f = h // cutoff
        flops += 2 * 9 * d * f * f * co * cutoff * cutoff
    return flops


def request(cfg, batch):
    """{part: operations} of one request of ``batch`` z, and ``total``."""
    style = cfg["style_dim"]
    ch = channel_map(cfg)
    convs = styled_convs(cfg, batch)
    mod = 0
    demod = 0
    rgb = 0
    cin = ch[4]
    mod += 2 * style * ch[4] * 2  # conv1 and to_rgb1
    demod += 2 * ch[4] * ch[4]
    rgb += 2 * ch[4] * 3 * 16
    for j in range(3, int(math.log2(cfg["size"])) + 1):
        c = ch[2 ** j]
        mod += 2 * style * (cin + c + c)
        demod += 2 * (cin * c + c * c)
        rgb += 2 * c * 3 * (2 ** j) ** 2
        cin = c
    d = cfg["segmentor"]["nclasses"]
    parts = {
        "mapping": 2 * style * style * cfg["n_mlp"] * batch,
        "modulation": (mod + demod) * batch,
        "synthesis_convs": sum(f for _, f, _ in convs),
        "to_rgb": rgb * batch,
        "folded_head": folded_head(cfg) * batch,
        "projection_sample0": sum(2 * u * d * r * r for r, u in _used(cfg)),
    }
    parts["total"] = sum(parts.values())
    return parts

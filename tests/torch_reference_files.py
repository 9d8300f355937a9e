"""Reference-format state_dicts made from seeded numpy, for the tests of
the port's checkpoint loaders (numpy only: the GPU tests, which run where
JAX is not installed, use them too)."""

import numpy as np

STYLE_DIM = 512
N_MLP = 2
# narrow rosinality-layout widths per resolution
NARROW = {4: 32, 8: 32, 16: 24, 32: 16, 64: 8}


def randn(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def modconv_sd(rng, prefix, cin, cout, k, mod="modulation"):
    return {f"{prefix}.weight": randn(rng, 1, cout, cin, k, k),
            f"{prefix}.{mod}.weight": randn(rng, cin, STYLE_DIM),
            f"{prefix}.{mod}.bias": 1.0 + randn(rng, cin, scale=0.1)}


def rosinality_g_ema(size, widths=NARROW, seed=0, noises=True):
    """A rosinality ``Generator`` state_dict (numpy) with the key layout JAX's
    convert reads: random weights, nonzero noise strengths and biases."""
    rng = np.random.RandomState(seed)
    log_size = int(np.log2(size))
    sd = {}
    for i in range(1, N_MLP + 1):
        sd[f"style.{i}.weight"] = randn(rng, STYLE_DIM, STYLE_DIM)
        sd[f"style.{i}.bias"] = randn(rng, STYLE_DIM, scale=0.1)
    sd["input.input"] = randn(rng, 1, widths[4], 4, 4)

    def styled(prefix, cin, cout):
        sd.update(modconv_sd(rng, prefix + ".conv", cin, cout, 3))
        sd[prefix + ".noise.weight"] = np.float32([rng.rand() * 0.5])
        sd[prefix + ".activate.bias"] = randn(rng, cout, scale=0.1)

    def to_rgb(prefix, cin):
        sd.update(modconv_sd(rng, prefix + ".conv", cin, 3, 1))
        sd[prefix + ".bias"] = randn(rng, 1, 3, 1, 1, scale=0.1)

    styled("conv1", widths[4], widths[4])
    to_rgb("to_rgb1", widths[4])
    cin = widths[4]
    for j, r in enumerate(2**k for k in range(3, log_size + 1)):
        styled(f"convs.{2 * j}", cin, widths[r])
        styled(f"convs.{2 * j + 1}", widths[r], widths[r])
        to_rgb(f"to_rgbs.{j}", widths[r])
        cin = widths[r]
    if noises:
        for li in range((log_size - 2) * 2 + 1):
            r = 2 ** ((li + 5) // 2)
            sd[f"noises.noise_{li}"] = randn(rng, 1, 1, r, r)
    return sd

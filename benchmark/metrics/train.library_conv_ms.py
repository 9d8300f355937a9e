"""train.library_conv_ms: device milliseconds an iteration in the library's
convolution and matmul kernels (cuDNN and cuBLAS; the patterns file), over
the traced window's iterations. Layer: the GAN trainer (gan/train.py,
models/stylegan2/discriminator.py), whose D convolutions and their
gradients run there."""


def read(outcome, patterns):
    tr = outcome.trace
    if tr is None or not patterns or not outcome.records:
        return None
    t = sum(d for name, _, d in tr.kernels if any(p.search(name) for p in patterns))
    if t <= 0:
        return None
    return t / 1e3 / len(outcome.records)

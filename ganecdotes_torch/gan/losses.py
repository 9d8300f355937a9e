"""GAN losses and regularizers (port of ganecdotes_tpu/gan/losses.py).

The regularizers take gradients of gradients with
``torch.autograd.grad(..., create_graph=True)``: the R1 and WGAN-GP
penalties through the discriminator (and ADA, for R1), the path-length
penalty through the synthesis network.
"""

import math

import torch
import torch.nn.functional as F

from ganecdotes_torch.parallel.mesh import all_reduce_sum

# ---------------------------------------------------------------------------
# adversarial objectives
# ---------------------------------------------------------------------------


def gan_loss(mode):
    """GANLoss factory: mode in {'vanilla', 'lsgan', 'bce', 'wgangp'}.
    Returns f(prediction, target_is_real) -> scalar."""
    if mode == "lsgan":
        def f(pred, real):
            target = torch.ones_like(pred) if real else torch.zeros_like(pred)
            return torch.mean((pred - target) ** 2)
    elif mode == "vanilla":
        def f(pred, real):
            target = torch.ones_like(pred) if real else torch.zeros_like(pred)
            return torch.mean(torch.clamp(pred, min=0) - pred * target
                              + torch.log1p(torch.exp(-pred.abs())))
    elif mode == "bce":
        def f(pred, real):
            target = torch.ones_like(pred) if real else torch.zeros_like(pred)
            p = torch.clamp(pred, 1e-7, 1 - 1e-7)
            return -torch.mean(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    elif mode == "wgangp":
        def f(pred, real):
            return -pred.mean() if real else pred.mean()
    else:
        raise NotImplementedError(f"gan mode {mode} not implemented")
    return f


def logistic_loss(pred_real, pred_fake):
    """softplus(-D(x)) + softplus(D(G(z))) (ref bagganhq.py:299-312)."""
    return F.softplus(-pred_real).mean() + F.softplus(pred_fake).mean()


def nonsaturating_loss(pred_fake):
    return F.softplus(-pred_fake).mean()


# ---------------------------------------------------------------------------
# regularizers
# ---------------------------------------------------------------------------


def _input(x):
    """``x`` as a tensor autograd can differentiate with respect to: itself
    when it already carries a graph, else a detached copy that requires
    grad."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def r1_penalty(disc_fn, real_images):
    """R1 = E[||grad_x D(x)||^2] on real images (ref bagganhq.py:272-296).
    ``disc_fn`` maps images to (B, 1) logits, with any augmentation inside
    it so the gradient flows through it. Returns (penalty, pred_real)."""
    x = _input(real_images)
    pred = disc_fn(x)
    (grad,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
    penalty = grad.reshape(grad.shape[0], -1).square().sum(dim=1).mean()
    return penalty, pred


def path_length_penalty(gen_latent_fn, latents, noise_imgs, mean_path_length,
                        decay=0.01, mesh=None):
    """Perceptual path-length regularizer (ref bagganhq.py:225-269).
    ``gen_latent_fn`` maps w+ latents to images; ``noise_imgs`` is the
    N(0, 1)/sqrt(HW) image-space probe. Returns (ppl, new_mean, lengths),
    the mean detached. Under a data-parallel ``mesh`` the lengths' mean is
    the global batch's (differentiably), and ``ppl`` the rank's share."""
    lat = _input(latents)
    img = gen_latent_fn(lat)
    (grad,) = torch.autograd.grad((img * noise_imgs).sum(), lat,
                                  create_graph=True)
    path_lengths = torch.sqrt(grad.square().sum(dim=2).mean(dim=1))
    if mesh is None or mesh.size == 1:
        mean_length = path_lengths.mean()
    else:
        mean_length = (all_reduce_sum(mesh, path_lengths.sum())
                       / (path_lengths.shape[0] * mesh.size))
    path_mean = mean_path_length + decay * (mean_length - mean_path_length)
    ppl = torch.mean((path_lengths - path_mean) ** 2)
    return ppl, path_mean.detach(), path_lengths


def gradient_penalty(disc_fn, real_data, fake_data, alpha=None, kind="mixed",
                     constant=1.0, lambda_gp=1.0):
    """WGAN-GP gradient penalty (ref gan_util.py:206-284). ``alpha`` is the
    (B, 1, 1, 1) interpolation draw of the 'mixed' kind, passed in.
    Returns (penalty, gradients)."""
    if lambda_gp <= 0.0:
        return 0.0, None
    if kind == "real":
        interp = real_data
    elif kind == "fake":
        interp = fake_data
    elif kind == "mixed":
        interp = alpha * real_data + (1 - alpha) * fake_data
    else:
        raise NotImplementedError(kind)
    x = _input(interp)
    pred = disc_fn(x)
    if isinstance(pred, tuple):
        pred = pred[0]
    (grads,) = torch.autograd.grad(pred.sum(), x, create_graph=True)
    flat = grads.reshape(real_data.shape[0], -1)
    norm = torch.linalg.vector_norm(flat + 1e-16, dim=1)
    return torch.mean((norm - constant) ** 2) * lambda_gp, grads


# ---------------------------------------------------------------------------
# auxiliary losses
# ---------------------------------------------------------------------------


def normal_nll_loss(x, mu, var):
    """Factored-Gaussian NLL for InfoGAN continuous codes (ref gan_util.py
    :395-413)."""
    logli = (-0.5 * torch.log(var * (2 * math.pi) + 1e-6)
             - (x - mu) ** 2 / (var * 2.0 + 1e-6))
    return -torch.mean(torch.sum(logli, dim=1))


def dice_loss(input_soft, target_soft, eps=1e-6):
    """Soft Dice over (B, H, W, C) maps (ref DiceLoss gan_util.py:494-534,
    NHWC here)."""
    dims = (1, 2, 3)
    intersection = torch.sum(input_soft * target_soft, dim=dims)
    cardinality = torch.sum(input_soft + target_soft, dim=dims)
    dice = 2.0 * intersection / (cardinality + eps)
    return torch.mean(1.0 - dice)

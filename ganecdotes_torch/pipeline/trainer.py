"""The supervised one-shot fine-tune (port of
ganecdotes_tpu/pipeline/trainer.py).

Adam over the segmentor head, the normalised weighted loss list, the logits
resized bilinearly and the label by nearest to ``image_size``. The JAX
package runs the epochs as ``lax.scan`` chunks; here an epoch is one pass of
a Python loop (forward, ``torch.autograd.grad``, Adam). No kernel of the
port runs here: the features are fixed, and the head's convs are
``F.conv2d``, which runs under cuDNN's deterministic algorithms: some of
its default algorithms for the heads' convs and their gradients sum in a
run-dependent order, and 200 epochs of Adam carry that difference into
another head (two runs of the same fine-tune on the same features ended
with losses 2-5% apart on an H100).
"""

import torch

from ganecdotes_torch.ops.interp import resize_bilinear, resize_nearest
from ganecdotes_torch.selfsup.lars import tree_leaves
from ganecdotes_torch.utils.optim import Adam


def make_supervised_finetune(apply_fn, loss_terms, image_size, lr,
                             betas=(0.9, 0.99), lr_sched=None,
                             stateful_sched=False):
    """Build (optimizer, run_chunk) for the fine-tune loop.

    ``apply_fn(params, state, features) -> (logits NHWC, new_state)``;
    ``loss_terms``: [(alpha, loss_fn)] with normalised alphas. ``lr_sched``:
    f(epoch) -> multiplier, evaluated on the update count before each update
    (epoch e takes ``lr * lr_sched(e)``, as optax's ``scale_by_schedule``).
    With ``stateful_sched`` the caller sets ``opt_state.lr`` between chunks.
    ``optimizer.init(params)`` returns the Adam state over the params'
    leaves, which it updates in place. ``run_chunk(params, opt_state, state,
    features, label, start, length)`` runs ``length`` epochs and returns
    (params, opt_state, state, last loss).
    """
    sched = None if stateful_sched else lr_sched

    class _Optimizer:
        @staticmethod
        def init(params):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            return Adam(leaves, lr, b1=betas[0], b2=betas[1])

    def loss_of(params, state, features, label):
        out, new_state = apply_fn(params, state, features)
        out = resize_bilinear(out, image_size)
        lbl = resize_nearest(label[..., None].to(torch.float32),
                             image_size)[..., 0].to(torch.int32)
        total = 0.0
        for alpha, lf in loss_terms:
            total = total + alpha * lf(out, lbl)
        return total, new_state

    def run_chunk(params, opt_state, state, features, label, start, length):
        del start  # epochs are counted by opt_state.count
        features = features.detach()
        loss = None
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for _ in range(length):
                if sched is not None:
                    opt_state.lr = lr * sched(opt_state.count)
                loss, state = loss_of(params, state, features, label)
                grads = torch.autograd.grad(loss, opt_state.params)
                opt_state.step(grads)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        return params, opt_state, state, loss.detach()

    return _Optimizer(), run_chunk

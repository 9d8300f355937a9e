"""The port's one-shot fine-tune held against the JAX package's: bilinear
resizing, the loss registry, the LR schedules and ``make_supervised_finetune``.

Same numpy inputs on both sides, on the CPU, float32 (JAX matmuls at
"highest" precision, the repo's conftest). Tolerances: the resizes sum two
products per axis, 1e-6 absolute; the losses 1e-6 relative; the step and
cosine multipliers 1e-7 (JAX computes them in float32; the port the step
in Python floats, the cosine in float32 in JAX's order); the plateau
multipliers equal (both are Python). The fine-tune: 6 epochs in chunks of
3 from equal head params, features and label; each
chunk's loss within 1e-5 relative, the params within 2e-5 absolute (the
convs sum in another order, and Adam's first steps move each weight by
about lr = 1e-3 whatever its gradient's size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganecdotes_tpu.ops import interp as jinterp
from ganecdotes_tpu.pipeline import losses as jlosses
from ganecdotes_tpu.pipeline import schedulers as jsched
from ganecdotes_tpu.pipeline.trainer import (
    make_supervised_finetune as jax_finetune,
)
from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_torch.configs import mapper as tmapper
from ganecdotes_torch.models.stylegan2.convert import from_jax_params
from ganecdotes_torch.ops import interp as tinterp
from ganecdotes_torch.pipeline import losses as tlosses
from ganecdotes_torch.pipeline import schedulers as tsched
from ganecdotes_torch.pipeline.trainer import make_supervised_finetune
from ganecdotes_torch.selfsup import heads as theads


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: torch on one thread (a thread pool only adds waits
    when test processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# resize_bilinear
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("src,dst", [((5, 7), (12, 16)), ((12, 16), (5, 7)),
                                     ((6, 20), (13, 9)), ((8, 8), (8, 8))],
                         ids=["up", "down", "mixed", "identity"])
def test_resize_bilinear_matches_jax(src, dst, align_corners):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    got = tinterp.resize_bilinear(torch.from_numpy(x), dst, align_corners)
    want = jinterp.resize_bilinear(jnp.asarray(x), dst, align_corners)
    assert tuple(got.shape) == (2, *dst, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert np.array_equal(tinterp._bilinear_matrix(src[0], dst[0], align_corners),
                          jinterp._bilinear_matrix(src[0], dst[0], align_corners))


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_torch_interpolate(align_corners):
    """torch's own F.interpolate semantics, up and down (torch computes
    each output as a lerp, not as two products: a few float32 ulps of
    values up to ~3, 2e-6 absolute)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 9, 11, 2).astype(np.float32))
    for size in [(18, 22), (4, 5)]:
        got = tinterp.resize_bilinear(x, size, align_corners)
        want = torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), size=size, mode="bilinear",
            align_corners=align_corners).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tmapper.losses))
def test_losses_match_jax(name):
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 6, 5, 4) * 3).astype(np.float32)
    if name == "bce":
        target = (rng.rand(2, 6, 5, 4) > 0.5).astype(np.float32)
    else:
        target = rng.randint(0, 4, size=(2, 6, 5)).astype(np.int32)
    jfn = {"bce": jlosses.bce_with_logits, "softmax": jlosses.softmax_loss,
           "sigmoid": jlosses.sigmoid_loss, "tanh": jlosses.tanh_loss,
           "logloss": jlosses.log_softmax_loss,
           "cross_entropy": jlosses.cross_entropy}[name]
    got = tmapper.losses[name](torch.from_numpy(logits), torch.from_numpy(target))
    want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(target)))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_cross_entropy_is_the_mean_over_pixels():
    logits = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 4, 3).astype(np.float32))
    target = torch.from_numpy(np.random.RandomState(4).randint(0, 3, (1, 4, 4)))
    want = torch.nn.CrossEntropyLoss()(logits.permute(0, 3, 1, 2), target)
    torch.testing.assert_close(tlosses.cross_entropy(logits, target), want)


@pytest.mark.parametrize("kind,kwargs", [
    ("step", dict(step_size=500, gamma=0.1)),
    ("step", dict(step_size=7, gamma=0.5)),
    ("cosine", dict(T_max=200)),
    ("cosine", dict(T_max=300, eta_min=0.05)),
])
def test_schedule_multipliers_match_jax(kind, kwargs):
    ours = tmapper.lr_scheduler[kind](**kwargs)
    theirs = {"step": jsched.step_lr, "cosine": jsched.cosine_lr}[kind](**kwargs)
    epochs = np.arange(0, 1201)
    want = np.asarray(jax.vmap(theirs)(jnp.asarray(epochs)))
    got = np.array([ours(int(e)) for e in epochs])
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("kwargs", [
    dict(patience=2, factor=0.5),
    dict(patience=0, factor=0.1, threshold=0.05, cooldown=2, min_lr_mult=0.002),
    dict(patience=1, factor=0.5, threshold=0.01, threshold_mode="abs"),
])
def test_plateau_multipliers_equal_jax(kwargs):
    rng = np.random.RandomState(5)
    trace = list(2.0 - 0.05 * np.arange(12)) + list(1.4 + 0.01 * rng.randn(30))
    ours, theirs = tsched.plateau_lr(**kwargs), jsched.plateau_lr(**kwargs)
    got = [ours.step(v) for v in trace]
    want = [theirs.step(v) for v in trace]
    assert got == want
    assert len(set(got)) > 1  # the trace reaches a reduction
    assert ours(0) == theirs(0)


# ---------------------------------------------------------------------------
# make_supervised_finetune against the JAX run_chunk
# ---------------------------------------------------------------------------

IN_CH, N_CLASS, FEAT = 16, 4, 16


def _finetune_case(size, image_size, label_size, seed=6):
    rng = np.random.RandomState(seed)
    feats = rng.randn(1, FEAT, FEAT, IN_CH).astype(np.float32)
    # a learnable label: the class of a smoothed feature channel's quantile
    lum = feats[0, :, :, 0] + feats[0, :, :, 1]
    lbl = np.digitize(lum, np.quantile(lum, [0.25, 0.5, 0.75]))
    if label_size != FEAT:
        lbl = np.kron(lbl, np.ones((label_size // FEAT,) * 2, dtype=lbl.dtype))
    params = jax.tree.map(np.asarray, jheads.init_one_shot_segmentor(
        jax.random.PRNGKey(seed), IN_CH, N_CLASS, size))
    return feats, lbl[None].astype(np.int64), params


@pytest.mark.parametrize("size", ["XXS", "S"])
@pytest.mark.parametrize("case", ["same_size", "bilinear", "plateau", "cosine"])
def test_finetune_matches_jax_run_chunk(size, case):
    image_size = 2 * FEAT if case == "bilinear" else FEAT
    feats, label, params = _finetune_case(size, image_size, FEAT)
    lr, betas = 1e-3, (0.9, 0.99)
    if case == "plateau":
        # threshold > 1 counts every loss as no better: the multiplier falls
        # after each chunk, so the second chunk runs at lr * 0.5
        sched_kw = dict(patience=0, factor=0.5, threshold=2.0)
        t_sched, j_sched = tsched.plateau_lr(**sched_kw), jsched.plateau_lr(**sched_kw)
    elif case == "cosine":
        t_sched, j_sched = tsched.cosine_lr(T_max=4), jsched.cosine_lr(T_max=4)
    else:
        t_sched, j_sched = tsched.step_lr(2, 0.5), jsched.step_lr(2, 0.5)
    stateful = case == "plateau"

    def japply(p, state, x):
        return jheads.one_shot_segmentor_apply(p, x, size), state

    def tapply(p, state, x):
        return theads.one_shot_segmentor_apply(p, x, size), state

    jopt, jrun = jax_finetune(
        japply, [(1.0, jlosses.cross_entropy)], image_size, lr, betas=betas,
        lr_sched=None if stateful else j_sched, stateful_sched=stateful)
    topt, trun = make_supervised_finetune(
        tapply, [(1.0, tlosses.cross_entropy)], image_size, lr, betas=betas,
        lr_sched=None if stateful else t_sched, stateful_sched=stateful)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = from_jax_params(params)
    tstate = topt.init(tp)
    jf, jl = jnp.asarray(feats), jnp.asarray(label)
    tf, tl = torch.from_numpy(feats), torch.from_numpy(label)
    losses = []
    for done in (0, 3):
        jp, jstate, _, jloss = jrun(jp, jstate, (), jf, jl, done, 3)
        tp, tstate, _, tloss = trun(tp, tstate, (), tf, tl, done, 3)
        losses.append((float(tloss), float(jloss)))
        if stateful:
            jstate.hyperparams["learning_rate"] = jnp.asarray(
                lr * j_sched.step(float(jloss)), jnp.float32)
            tstate.lr = lr * t_sched.step(float(tloss))
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want), losses
    assert losses[1][1] < losses[0][1]  # it learns
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    [t.detach().numpy() for t in _leaves(tp)]):
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=0)
    assert tstate.count == 6


def _leaves(params):
    # jax.tree.leaves order: the list in order, each dict's keys sorted
    return [layer[k] for layer in params for k in sorted(layer)]


def test_finetune_lr_is_evaluated_before_the_update():
    """Epoch e runs at lr * sched(e): with a multiplier of 0 from epoch 1 on,
    only the first update moves the params."""
    feats, label, params = _finetune_case("XXS", FEAT, FEAT)

    def tapply(p, state, x):
        return theads.one_shot_segmentor_apply(p, x, "XXS"), state

    opt, run = make_supervised_finetune(
        tapply, [(1.0, tlosses.cross_entropy)], FEAT, 1e-3,
        lr_sched=lambda e: 1.0 if e == 0 else 0.0)
    tp = from_jax_params(params)
    state = opt.init(tp)
    tp, state, _, _ = run(tp, state, (), torch.from_numpy(feats),
                          torch.from_numpy(label), 0, 1)
    after_one = [t.detach().clone() for t in _leaves(tp)]
    assert not torch.equal(after_one[0], from_jax_params(params)[0]["bias"])
    tp, state, _, _ = run(tp, state, (), torch.from_numpy(feats),
                          torch.from_numpy(label), 1, 3)
    for a, b in zip(after_one, _leaves(tp)):
        assert torch.equal(a, b.detach())


def test_adam_matches_optax():
    """The shared Adam against optax.adam on equal gradients."""
    from ganecdotes_torch.utils.optim import Adam

    rng = np.random.RandomState(7)
    p = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * 10.0 ** -k for k in range(4)]
    opt = optax.adam(1e-3, b1=0.9, b2=0.99)
    jp, js = jnp.asarray(p), opt.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    adam = Adam([tp], 1e-3, b1=0.9, b2=0.99)
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(g)])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7, rtol=0)

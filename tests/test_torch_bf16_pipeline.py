"""Every method's one-shot pipeline with the model config's
``inference_dtype = 'bfloat16'``, held against the JAX pipeline's bf16 test
block on the CPU, at the tiny configs of tests/test_pipeline.py (the types
and the tolerances: tests/test_torch_bf16.py's docstring).

Measured here (the labels of 3 test samples at 32^2): the port's bf16
labels agree with JAX's bf16 labels on 0.989-1.000 of the pixels and with
the port's own float32 server on 0.991-1.000 (hfc_with_swav 0.9928 /
0.9951, RepurposeGAN 0.9980 / 0.9987, DatasetGAN 1.0000 / 0.9997,
hfc_with_simclr 0.9925 / 0.9941, hfc_kmeans 0.9889 / 0.9909), against
JAX's gate of 95%.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganecdotes_tpu.selfsup import heads as jheads
from ganecdotes_tpu.selfsup import swav as jswav
from ganecdotes_tpu.utils.serialization import save_pytree as jax_save_pytree
from ganecdotes_torch.models.stylegan2.convert import from_jax_generator_params
from ganecdotes_torch.pipeline.one_shot_pipeline import OneShotPipeline
from test_pipeline import TINY_SWAV
from test_torch_bf16 import LABEL_GATE
from test_torch_methods import METHOD_CONFIGS, METHOD_IN_CH, _method_files
from test_torch_pipeline import (
    HLEN,
    N_TEST,
    NCLASSES,
    NPROTO,
    SIZE,
    _evaluate_mode,
    _samples,
    _write_configs,
    one_torch_thread,  # noqa: F401  (the autouse fixture)
)

# ---------------------------------------------------------------------------
# serving: OneShotPipeline with inference_dtype = 'bfloat16'
# ---------------------------------------------------------------------------

SERVE_METHODS = {"hfc_with_swav": TINY_SWAV, **METHOD_CONFIGS}


def _bf16_pipelines(tmp_path, method):
    """The JAX and the port pipelines of ``method`` at the tiny configs, the
    model config with ``inference_dtype = 'bfloat16'``, from the same files
    and carried weights (tests/test_torch_pipeline.py and
    tests/test_torch_methods.py): the fine-tune runs in float32 in both,
    the test requests in bf16."""
    from ganecdotes_tpu.pipeline.one_shot_pipeline import OneShotPipeline as JaxPipeline

    cfg = _write_configs(str(tmp_path), *_samples(str(tmp_path)),
                         seg=SERVE_METHODS[method])
    with open(cfg["model"], "a") as f:
        f.write("\ninference_dtype = 'bfloat16'\n")
    outs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in outs.values():
        os.makedirs(d)
    key = jax.random.PRNGKey(12)
    state = None
    if method == "hfc_with_swav":
        ssl = jax.tree.map(np.asarray, jswav.init_swav_params(
            jax.random.PRNGKey(11), HLEN, NCLASSES, NPROTO, "linear"))
        for d in outs.values():
            jax_save_pytree(os.path.join(d, "swav_params.npz"), ssl)
        init = jheads.init_one_shot_segmentor(key, NCLASSES, 4, "XXS")
    else:
        _method_files(method, outs.values())
        if method == "datasetgan":
            init, state = jheads.init_pixel_classifier(key, METHOD_IN_CH[method], 4)
            state = jax.tree.map(np.asarray, state)
        else:
            size = {"repurposegan": "XS", "hfc_with_simclr": "XS", "hfc_kmeans": "S"}
            init = jheads.init_one_shot_segmentor(key, METHOD_IN_CH[method], 4,
                                                  size[method])
    init = jax.tree.map(np.asarray, init)

    jpipe = JaxPipeline(out_dir=outs["jax"], model="ffhq-256", segmentor=method,
                        num_test_samples=N_TEST, custom=cfg)
    _evaluate_mode(jpipe)
    jpipe.segmentor_init_params = jax.tree.map(jnp.asarray, init)
    if state is not None:
        jpipe.segmentor_init_state = jax.tree.map(jnp.asarray, state)
    jpipe.run_pipeline()

    gen = from_jax_generator_params(jax.tree.map(np.asarray, jpipe.model.params))
    pipe = OneShotPipeline(out_dir=outs["torch"], model="ffhq-256", segmentor=method,
                           num_test_samples=N_TEST, custom=cfg, device="cpu", gen=gen,
                           mean_latent=np.asarray(jpipe.mean_latent))
    _evaluate_mode(pipe)
    if method in ("hfc_with_swav", "hfc_with_simclr"):
        pipe.preprocessor = pipe._build_ssl_preprocessor()  # loads the params
    if jpipe.preprocessor is not None:
        pipe.preprocessor.mean_latent = torch.from_numpy(
            np.array(jpipe.preprocessor.mean_latent))
    pipe.segmentor_init_params = init
    pipe.segmentor_init_state = state
    pipe.run_pipeline()
    return jpipe, pipe, outs


@pytest.mark.parametrize("method", list(SERVE_METHODS))
def test_pipeline_serves_in_bf16_as_jax_does(tmp_path, method):
    """The test block in bf16 against JAX's bf16 program on the same trained
    weights: the labels on >= LABEL_GATE of the pixels, and against the
    port's own float32 server the same; the folded request against the
    unfused one (both bf16): the image equal, labels on >= LABEL_GATE; the
    images in bf16, the weights untouched (float32)."""
    jpipe, pipe, outs = _bf16_pipelines(tmp_path, method)
    jpred = np.load(os.path.join(outs["jax"], "tests", "label_predictions.npy"))
    pred16 = pipe.pred_labels.copy()
    assert pred16.shape == jpred.shape == (N_TEST, SIZE, SIZE)
    assert pipe.server.dtype is torch.bfloat16
    assert (pred16 == jpred).mean() >= LABEL_GATE, (pred16 == jpred).mean()

    w = torch.as_tensor(pipe.test_latents[:N_TEST])
    img, logits, _ = pipe.server.infer_folded(w, input_is_latent=True)
    u_img, u_logits, _ = pipe.server.infer(w, input_is_latent=True)
    assert img.dtype == torch.bfloat16 and torch.equal(img, u_img)
    assert (logits.argmax(-1) == u_logits.argmax(-1)).float().mean() >= LABEL_GATE
    assert all(p.dtype == torch.float32 for p in pipe.model.parameters())

    pipe.model_config.inference_dtype = "float32"
    pred32 = pipe.predict_tests()
    assert pipe.server.dtype is None
    assert (pred16 == pred32).mean() >= LABEL_GATE, (pred16 == pred32).mean()

"""The serving export (port of ganecdotes_tpu/runtime/export.py): a trained
pipeline's request, generate -> embed -> segment -> argmax, as one
``torch.export`` program in a one-file artifact.

The artifact (``.ganex``) keeps the JAX package's layout: a zip with
``program.bin`` (here the bytes of ``torch.export.save``) and ``meta.json``
(``format_version``, the input and output shapes and dtypes, ``kind``,
``segmentor``, ``batch``, ``latent_dim``, ``classes``, ``platforms`` and the
torch version; here also ``sm_count``). The trained weights, the fixed
noise buffers and every other tensor the request reads live inside the
program. A newer ``format_version`` is refused.

The program runs the hand-written kernels: it is traced on the op set
``ops.library.LIBRARY``, whose four serving kernels are custom ops that
launch the same C entries as the live server's wrappers on CUDA tensors
and run the plain versions on CPU tensors. So, unlike JAX's artifact,
which needs only ``jax``, loading one needs the ``ganecdotes`` ops
registered: ``load_exported`` imports ``ganecdotes_torch.ops.library``
first. Which kernel variant runs is chosen when the program runs, from
the shapes and the card's SM count, as in the live server; ``sm_count``
records the exporting card's. A program exported on the card runs on the
CPU after ``torch.export.passes.move_to_device_pass`` (``load_exported(...,
device="cpu")``).
"""

import copy
import io
import json
import zipfile

import torch
from torch import nn

_FORMAT_VERSION = 1
PLATFORMS = ["cuda", "cpu"]


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def export_fn(fn, example_args, path, meta=None):
    """Export ``fn`` (a callable or an ``nn.Module``) at ``example_args``'
    shapes and devices to ``path``; returns the metadata written beside
    the program. Traced under ``torch.no_grad()``: the program serves, it
    does not train."""
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    args = tuple(torch.as_tensor(a) for a in example_args)
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    outs = [n.meta["val"] for n in program.graph.output_node().args[0]]
    out_meta = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(PLATFORMS),
        "in_shapes": [list(a.shape) for a in args],
        "in_dtypes": [_dtype_name(a.dtype) for a in args],
        "out_shapes": [list(o.shape) for o in outs],
        "out_dtypes": [_dtype_name(o.dtype) for o in outs],
    }
    out_meta.update(meta or {})
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(out_meta, indent=1))
        z.writestr("program.bin", buf.getvalue())
    return out_meta


def load_exported(path, device=None):
    """Load a ``.ganex`` artifact -> (callable, metadata). The callable
    takes the exported function's arguments and runs the program under
    ``torch.no_grad()``; ``device`` moves the program there first."""
    import ganecdotes_torch.ops.library  # noqa: F401  (registers the ops)

    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format_version", 0) > _FORMAT_VERSION:
            raise ValueError(
                f"artifact {path} has format_version {meta['format_version']} "
                f"> supported {_FORMAT_VERSION}")
        program = torch.export.load(io.BytesIO(z.read("program.bin")))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    module = program.module()

    def call(*args):
        with torch.no_grad():
            return module(*args)

    return call, meta


class _Serving(nn.Module):
    """A server's folded request on latents w -> (img, labels) or (img,
    labels, z0), on the op set ``ops``; the generator is a submodule, so
    its parameters and noise buffers are the program's."""

    def __init__(self, server, ops):
        super().__init__()
        self.gen = server.gen
        self.server = copy.copy(server)
        self.server.ops = ops

    def forward(self, latents):
        from ganecdotes_torch.pipeline.serving import _argmax

        out = _argmax(*self.server._folded(latents))
        return out if out[2] is not None else out[:2]


def export_serving(source, path, batch=None):
    """Export the serving request of ``source``, a trained
    ``OneShotPipeline`` (its method's server) or a server of
    ``pipeline.serving``: latents w (batch, latent_dim) -> the server's
    (img, labels[, z0]), the weights inside the program. ``batch`` defaults
    to the pipeline's test batch. Call after training, so the weights are
    final."""
    from ganecdotes_torch.ops.library import LIBRARY
    from ganecdotes_torch.pipeline.one_shot_pipeline import MAX_TEST_BATCH

    if hasattr(source, "make_server"):
        server = source.make_server()
        segmentor = source.seg_str
        classes = list(getattr(source.model_config, "classes", []))
    else:
        server, segmentor = source, source.method
        classes = list(getattr(source, "classes", []))
    batch = MAX_TEST_BATCH if batch is None else int(batch)
    latent_dim = int(server.gen.meta["style_dim"])
    device = server.device
    sm_count = (torch.cuda.get_device_properties(device).multi_processor_count
                if device.type == "cuda" else None)
    example = torch.zeros((batch, latent_dim), dtype=torch.float32, device=device)
    return export_fn(_Serving(server, LIBRARY), (example,), path, meta={
        "kind": "one_shot_serving", "segmentor": segmentor, "batch": batch,
        "latent_dim": latent_dim, "classes": classes, "sm_count": sm_count})

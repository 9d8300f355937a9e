"""The port's public API held to the JAX package's.

An AST walk lists every public function, class and class method (no
leading underscore) defined at the top level of each module of
``ganecdotes_tpu``. Each must have a counterpart in ``ganecdotes_torch``:

* the same name in the port's module of the same path, or in the module a
  Pallas file was renamed to (``ops/<name>_pallas.py`` -> ``ops/<name>.py``),
  found by importing that module (a method may be inherited);
* else an entry of ``COUNTERPARTS``: the dotted name of the port's object
  that does the same work under another name or form, imported and
  resolved here, so an entry cannot point at nothing;
* else an entry of ``ABSENT``, with the reason the port has none.

An entry of either table for a name that the same-name rule already finds
fails too, so the tables cannot go stale. The walk imports no module of
the JAX package.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "ganecdotes_tpu", "ganecdotes_torch"

# JAX name (module path :: name) -> the port's counterpart, by dotted name
COUNTERPARTS = {
    # the Pallas kernels -> the CUDA kernels' wrappers
    "ops/fused_act.py::fused_leaky_relu_pallas": "ganecdotes_torch.ops.fused_act.fused_leaky_relu",
    "ops/upfirdn2d_pallas.py::upfirdn2d_pallas": "ganecdotes_torch.ops.upfirdn2d.upfirdn2d",
    "ops/sinkhorn_pallas.py::sinkhorn_knopp_pallas": "ganecdotes_torch.ops.sinkhorn.sinkhorn_knopp",
    "ops/affine_warp_pallas.py::resample_rows": "ganecdotes_torch.ops.resample.resample_rows",
    "ops/affine_warp_pallas.py::resample_rows_t": "ganecdotes_torch.ops.resample.resample_rows_t",
    # whether a Pallas kernel takes a shape, and the switches between a
    # kernel and jnp -> the port's variant selection and limits (the caller
    # picks the op set, KERNELS or PLAIN, instead of an environment flag)
    "ops/modulated_conv_pallas.py::pallas_supported": "ganecdotes_torch.ops.modulated_conv.variant",
    "ops/modulated_conv_pallas.py::up_pallas_supported": "ganecdotes_torch.ops.modulated_conv.variant",
    "ops/upfirdn2d_pallas.py::fits": "ganecdotes_torch.ops.upfirdn2d.plan",
    "ops/sinkhorn_pallas.py::sinkhorn_supported": "ganecdotes_torch.ops.sinkhorn.MAX_K",
    "ops/sinkhorn_pallas.py::sinkhorn_impl_flag": "ganecdotes_torch.ops.opset.OpSet",
    # the up kernel's phase stack, in the layout the CUDA kernel reads
    "ops/subpixel_upconv.py::phase_stack_major": "ganecdotes_torch.ops.subpixel_upconv.phase_stack",
    # XLA's persistent compilation cache -> the content-hashed kernel build
    "runtime/compile_cache.py::enable_persistent_compilation_cache": "ganecdotes_torch.ops._build.load",
    # functional inits -> the nn.Module constructors
    "nn/layers.py::equal_conv2d_init": "ganecdotes_torch.nn.layers.EqualConv2d",
    "nn/layers.py::equal_linear_init": "ganecdotes_torch.nn.layers.EqualLinear",
    "models/stylegan2/generator.py::init_generator": "ganecdotes_torch.models.stylegan2.generator.Generator",
    "models/stylegan2/discriminator.py::init_discriminator": "ganecdotes_torch.models.stylegan2.discriminator.Discriminator",
    "models/stylegan2/discriminator.py::init_discriminator_q": "ganecdotes_torch.models.stylegan2.discriminator.DiscriminatorQ",
    # the JAX Generator's methods -> module functions over the nn.Module
    "models/stylegan2/generator.py::Generator.style": "ganecdotes_torch.models.stylegan2.generator.mapping_apply",
    "models/stylegan2/generator.py::Generator.make_noise": "ganecdotes_torch.models.stylegan2.generator.make_noise",
    "models/stylegan2/generator.py::Generator.mean_latent": "ganecdotes_torch.models.stylegan2.generator.mean_latent",
}

# JAX name -> why the port has no counterpart
NO_QUIET_FALLBACK = ("JAX's make_loader falls back to the Python loader without a word; "
                     "the port refuses such a fallback and has only the native loader "
                     "(tests/test_torch_runtime.py pins the absence)")
ABSENT = {
    "runtime/__init__.py::PyDataLoader": NO_QUIET_FALLBACK,
    "runtime/__init__.py::PyDataLoader.close": NO_QUIET_FALLBACK,
    "runtime/__init__.py::PyDataLoader.next": NO_QUIET_FALLBACK,
    "runtime/__init__.py::make_loader": NO_QUIET_FALLBACK,
}


def _public_names(path):
    """Top-level public functions and classes of a module, and the public
    methods of each class, as 'name' and 'Class.method'."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")]
    return out


def _jax_names():
    names = []
    base = os.path.join(ROOT, JAX_PKG)
    for d, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), base).replace(os.sep, "/")
                names += [(rel, n) for n in _public_names(os.path.join(d, f))]
    return sorted(names)


def _port_modules(rel):
    """The port's module names for a JAX module path (and its Pallas file's
    renamed one), those that exist."""
    cands = [rel]
    if rel.startswith("ops/") and rel.endswith("_pallas.py"):
        cands.append(rel[: -len("_pallas.py")] + ".py")
    mods = []
    for c in cands:
        if os.path.exists(os.path.join(ROOT, PORT_PKG, c)):
            dotted = c[:-3].replace("/", ".")
            dotted = dotted[: -len(".__init__")] if dotted.endswith(".__init__") else dotted
            mods.append(f"{PORT_PKG}.{dotted}" if dotted != "__init__" else PORT_PKG)
    return mods


def _getattr_path(obj, path):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _has_same_name(rel, name):
    for mod in _port_modules(rel):
        try:
            _getattr_path(importlib.import_module(mod), name)
            return True
        except AttributeError:
            continue
    return False


def _resolve(dotted):
    """Import the longest module prefix of ``dotted`` and get the rest."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        return _getattr_path(mod, ".".join(parts[i:])) if i < len(parts) else mod
    raise ImportError(dotted)


JAX_NAMES = _jax_names()


def test_the_walk_sees_the_jax_package():
    """The walk finds the modules and names these tables speak of."""
    keys = {f"{rel}::{n}" for rel, n in JAX_NAMES}
    assert len(JAX_NAMES) > 250
    assert set(COUNTERPARTS) <= keys and set(ABSENT) <= keys
    assert not set(COUNTERPARTS) & set(ABSENT)
    assert "utils/serialization.py::save_pytree_orbax" in keys
    assert "gan/train.py::GANBaseModel.set_requires_grad" in keys


@pytest.mark.parametrize("package_dir", sorted(
    {rel.split("/")[0] if "/" in rel else rel for rel, _ in JAX_NAMES}))
def test_every_jax_name_has_a_port_counterpart(package_dir):
    """Per top-level part of the package (``ops``, ``gan``, ...): each
    public name exists under the same name in the port, or is in one of
    the tables."""
    missing, stale = [], []
    for rel, name in JAX_NAMES:
        if (rel.split("/")[0] if "/" in rel else rel) != package_dir:
            continue
        key = f"{rel}::{name}"
        same = _has_same_name(rel, name)
        if key in COUNTERPARTS or key in ABSENT:
            if same:
                stale.append(key)
        elif not same:
            missing.append(key)
    assert not missing, f"JAX names with no counterpart in the port: {missing}"
    assert not stale, f"table entries the port now has under the same name: {stale}"


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_counterpart_resolves(key):
    obj = _resolve(COUNTERPARTS[key])
    assert obj is not None
    assert not COUNTERPARTS[key].startswith(JAX_PKG)


def test_only_the_python_loader_is_absent():
    assert {k.split("::")[1].split(".")[0] for k in ABSENT} == {"PyDataLoader", "make_loader"}
    runtime = importlib.import_module(f"{PORT_PKG}.runtime")
    assert not hasattr(runtime, "PyDataLoader") and not hasattr(runtime, "make_loader")

"""Checkpoints of nested dicts, lists and tuples of tensors (port of
ganecdotes_tpu/utils/serialization.py).

``save_pytree`` / ``load_pytree``: one flat-key ``.npz`` file, the format
the two packages share.

The keys are the JAX package's: ``leaf:<path>`` for an array, with ``/``
between dict keys and ``#i`` for list items, ``__len__<path>`` holding
(length, is_tuple) for a list or tuple, and a ``__bf16__leaf:<path>`` marker
beside a bfloat16 leaf stored as its uint16 bits. So a file written by either
package loads in the other. Leaves load as CPU tensors.

``save_pytree_orbax`` / ``load_pytree_orbax``: a directory written by
``torch.distributed.checkpoint`` (DCP), the counterpart of the JAX
package's orbax pair under the same names, for data-parallel runs: every
rank of a process group calls it, and each rank's replicated tensors are
written once. ``like`` restores onto the devices of another layout, such as
one card after a multi-rank run. The directory is DCP's format, not
orbax's: neither package reads the other's directories.
"""

import json
import warnings

import numpy as np
import torch
import torch.distributed as dist


def _flatten(tree):
    flat = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            flat[f"__len__{path}"] = np.asarray(
                [len(node), int(isinstance(node, tuple))])
            for i, v in enumerate(node):
                rec(v, f"{path}#{i}")
        elif isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            if t.dtype == torch.bfloat16:
                flat[f"__bf16__leaf:{path}"] = np.asarray([1])
                t = t.view(torch.int16)
                flat[f"leaf:{path}"] = t.numpy().view(np.uint16)
            else:
                flat[f"leaf:{path}"] = t.numpy()
        else:
            flat[f"leaf:{path}"] = np.asarray(node)

    rec(tree, "")
    return flat


def save_pytree(path, tree):
    """Uncompressed (``np.savez``; ``np.load`` reads either): random-looking
    float weights shrink by under a tenth, and zlib's pass over a
    full-width discriminator costs seconds of host time at every checkpoint
    of a training run, 30 times the uncompressed write."""
    np.savez(path, **_flatten(tree))


def load_pytree(path):
    data = dict(np.load(path, allow_pickle=False))

    def rec(path_):
        len_key = f"__len__{path_}"
        leaf_key = f"leaf:{path_}"
        if leaf_key in data:
            arr = data[leaf_key]
            if f"__bf16__{leaf_key}" in data:
                return torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(np.array(arr))
        if len_key in data:
            n, is_tuple = int(data[len_key][0]), bool(data[len_key][1])
            items = [rec(f"{path_}#{i}") for i in range(n)]
            return tuple(items) if is_tuple else items
        # dict: collect child keys one level down
        prefix = f"{path_}/" if path_ else ""
        children = set()
        for k in data:
            if k.startswith("__bf16__"):
                continue
            body = k.split(":", 1)[1] if k.startswith("leaf:") else k[len("__len__"):]
            if body.startswith(prefix) and len(body) > len(prefix):
                rest = body[len(prefix):]
                children.add(rest.split("/")[0].split("#")[0])
        if not children:
            raise KeyError(f"no entries under '{path_}' in {path}")
        return {c: rec(f"{prefix}{c}") for c in children}

    return rec("")


# ---------------------------------------------------------------------------
# torch.distributed.checkpoint directories
# ---------------------------------------------------------------------------

_TREE_KEY = "__tree__"  # the containers, as JSON bytes in a uint8 tensor


def _skeleton(node, flat, path="", convert=True):
    """``node``'s containers as a JSON-able skeleton; each leaf goes into
    ``flat`` under its ``leaf:<path>`` key (the ``.npz`` keys' paths). A
    leaf that is not a tensor is made one, or with ``convert=False``
    raises."""
    if isinstance(node, dict):
        return {"dict": {str(k): _skeleton(node[k], flat, f"{path}/{k}" if path else str(k),
                                           convert) for k in sorted(node)}}
    if isinstance(node, (list, tuple)):
        kind = "tuple" if isinstance(node, tuple) else "list"
        return {kind: [_skeleton(v, flat, f"{path}#{i}", convert)
                       for i, v in enumerate(node)]}
    key = f"leaf:{path}"
    if key in flat:
        raise ValueError(f"two leaves of the tree have the key {key!r}")
    if not isinstance(node, torch.Tensor):
        if not convert:
            raise TypeError(f"{key} is a {type(node).__name__}, not a tensor")
        node = torch.as_tensor(np.asarray(node))
    flat[key] = node
    return key


def _rebuild(skel, flat):
    """The tree of ``skel`` with its leaves from ``flat``. A non-empty tuple
    comes back as a list and an empty one as (), as orbax's restore without
    a target gives them."""
    if isinstance(skel, str):
        return flat[skel]
    (kind, body), = skel.items()
    if kind == "dict":
        return {k: _rebuild(v, flat) for k, v in body.items()}
    items = [_rebuild(v, flat) for v in body]
    return () if kind == "tuple" and not items else items


def _dcp(fn, flat, path):
    """DCP's ``save`` or ``load`` of ``flat`` at ``path``: over the process
    group where there is one, else in this process alone (which DCP warns
    about every call)."""
    no_dist = not (dist.is_available() and dist.is_initialized())
    with warnings.catch_warnings():
        if no_dist:
            warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(flat, checkpoint_id=str(path), no_dist=no_dist)


def save_pytree_orbax(path, tree):
    """Save ``tree`` (nested dicts, lists and tuples of tensors on any
    device, bf16 included; numpy arrays and scalars become tensors) to the
    DCP directory ``path``, replacing what it held. Without a process group
    this process writes the whole tree. In a process group every rank must
    call it with a tree of the same keys, shapes and dtypes: DCP writes each
    key once, from one rank, so the tensors must be replicated (the
    port's ranks hold replicated parameters, ``parallel/mesh.py``). A
    failed write raises."""
    import torch.distributed.checkpoint as dcp

    flat = {}
    skel = json.dumps(_skeleton(tree, flat)).encode()
    flat[_TREE_KEY] = torch.frombuffer(bytearray(skel), dtype=torch.uint8)
    flat = {k: v.detach().contiguous() for k, v in flat.items()}
    _dcp(dcp.save, flat, path)


def load_pytree_orbax(path, like=None):
    """Restore the tree saved at ``path`` by ``save_pytree_orbax``.

    Without ``like``: the saved tree with the saved shapes and dtypes, CPU
    tensors (a non-empty tuple comes back as a list, as in the JAX
    package). With ``like``, a tree of tensors of the saved tree's keys:
    each saved tensor is copied into ``like``'s tensor of the same key, in
    place and on that tensor's device, and ``like`` is returned with its
    own containers. So a checkpoint written by several ranks restores onto
    one card. A key that either side lacks, or a ``like`` tensor of
    another shape or dtype than the saved one, raises: nothing is cast. In
    a process group every rank must call it. A failed read raises."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata().state_dict_metadata
    if _TREE_KEY not in meta:
        raise ValueError(f"{path}: not a directory written by save_pytree_orbax")
    saved = {k: m for k, m in meta.items() if k != _TREE_KEY}
    flat = {}
    if like is not None:
        _skeleton(like, flat, convert=False)
        if set(flat) != set(saved):
            raise KeyError(f"{path}: like's keys {sorted(set(flat) - set(saved))} are "
                           f"not in the checkpoint, its {sorted(set(saved) - set(flat))} "
                           "not in like")
        for key, t in flat.items():
            m = saved[key]
            if t.shape != m.size or t.dtype != m.properties.dtype:
                raise ValueError(f"{path}: {key} is saved as {tuple(m.size)} "
                                 f"{m.properties.dtype}, like's is {tuple(t.shape)} "
                                 f"{t.dtype}")
    else:
        flat = {k: torch.empty(m.size, dtype=m.properties.dtype) for k, m in saved.items()}
    m = meta[_TREE_KEY]
    flat[_TREE_KEY] = torch.empty(m.size, dtype=m.properties.dtype)
    _dcp(dcp.load, flat, path)
    if like is not None:
        return like
    return _rebuild(json.loads(bytes(flat.pop(_TREE_KEY).tolist())), flat)

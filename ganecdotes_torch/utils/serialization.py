"""Flat-key ``.npz`` checkpoints for nested dicts and lists of tensors (the
port's numpy-only copy of ganecdotes_tpu/utils/serialization.py
``save_pytree``/``load_pytree``).

The keys are the JAX package's: ``leaf:<path>`` for an array, with ``/``
between dict keys and ``#i`` for list items, ``__len__<path>`` holding
(length, is_tuple) for a list or tuple, and a ``__bf16__leaf:<path>`` marker
beside a bfloat16 leaf stored as its uint16 bits. So a file written by either
package loads in the other. Leaves load as CPU tensors.
"""

import numpy as np
import torch


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

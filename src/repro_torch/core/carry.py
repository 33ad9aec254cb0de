"""Load the reference's parameter tree into the port's ``Model``.

``load_jax_params(model, tree)`` takes the JAX package's parameters as a
nested dict of numpy arrays — ``jax.tree.map(np.asarray, params)`` of
``Model.init_params(key)[0]`` (after ``split_annotations``) — and copies them
into the model's parameters of the same key paths.  Every key, shape and
dtype must match: a missing or extra key, or a mismatch, raises.  A tree
whose cores the reference squeezed carries in through
``model.set_tree(jax_tree_to_torch(tree))``, which lets the cores' bonds
differ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model, _flatten


def to_tensor(arr) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of its dtype; a tensor as is."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":   # numpy has no bfloat16: reinterpret bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def jax_tree_to_torch(tree: dict) -> dict:
    """The reference's tree of numpy arrays as the same nested dict of CPU
    tensors (bfloat16 kept)."""
    return {k: jax_tree_to_torch(v) if isinstance(v, dict) else to_tensor(v)
            for k, v in tree.items()}


def load_jax_params(model: Model, tree: dict) -> Model:
    """Copy ``tree`` into ``model`` (in place) and return the model."""
    src = _flatten(jax_tree_to_torch(tree))
    dst = dict(model.named_parameters())
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, param in dst.items():
            t = src[name]
            if tuple(t.shape) != tuple(param.shape) or t.dtype != param.dtype:
                raise ValueError(f"{name}: reference has {tuple(t.shape)} {t.dtype}, "
                                 f"model has {tuple(param.shape)} {param.dtype}")
            param.copy_(t)
    return model

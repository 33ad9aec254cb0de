"""Lightweight fine-tuning (paper §4.1): train only the auxiliary tensors —
the port of ``repro.core.lightweight``.

After MPO decomposition the *central* tensor holds most parameters; the paper
freezes it and fine-tunes only the auxiliary tensors (and the small non-MPO
leaves: norms, biases).  The port realizes this, as the reference does, as a
boolean *trainability mask* over the nested parameter dict, consumed by the
optimizer: masked leaves never receive updates and never allocate optimizer
state.
"""

from __future__ import annotations

import torch


def leaves(tree):
    """The tensors of a nested dict, in JAX's leaf order (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _is_core_key(key: str) -> bool:
    return key.startswith("c") and key[1:].isdigit()


def trainable_mask(params, *, mode: str = "lfa", train_non_mpo: bool = True):
    """Nested dict of bools, True = trainable, with ``params``' key paths.

    mode="full" -> everything trainable (paper's MPOP_full baseline);
    mode="lfa"  -> central cores frozen (paper's lightweight fine-tuning);
    mode="central_only" -> inverse ablation (aux frozen)."""
    if mode not in ("full", "lfa", "central_only"):
        raise ValueError(mode)

    def label(path: tuple) -> bool:
        if mode == "full":
            return True
        central = "central" in path
        if mode == "lfa":
            if central:
                return False
            return True if any(_is_core_key(k) for k in path) else train_non_mpo
        return central

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return label(path)

    return walk(params, ())


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree) if hasattr(t, "numel"))


def count_trainable(params, mask) -> tuple[int, int]:
    """(trainable, total) parameter counts."""
    total = train = 0
    for leaf, m in zip(leaves(params), leaves(mask)):
        total += leaf.numel()
        if m:
            train += leaf.numel()
    return train, total


def apply_mask_to_grads(grads, mask):
    """Zero the gradients of frozen leaves (same dict structure)."""
    return tree_map(lambda g, m: g if m else torch.zeros_like(g), grads, mask)


def reduction_savings(params, mask) -> float:
    """Fraction of gradient all-reduce bytes eliminated by LFA."""
    train, total = count_trainable(params, mask)
    return 1.0 - train / max(total, 1)

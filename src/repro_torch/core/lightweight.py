"""Parameter counting — the part of ``repro.core.lightweight`` serving needs.
The trainability masks of lightweight fine-tuning come with training
(ROADMAP.md, Queue 1 item 5)."""

from __future__ import annotations


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def count_params(tree) -> int:
    return sum(t.numel() for t in _leaves(tree) if hasattr(t, "numel"))

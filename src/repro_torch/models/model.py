"""``Model``: the dense transformer as an ``nn.Module`` — the port of
``repro.models.model``.

Parameters are registered under the reference's key paths
(``embed.cores.c0``, ``layers.attn.wq.cores.central``, ``layers.ln1.scale``,
…) with the stacked leading layer dim kept, so ``state_dict()`` keys match
the reference's parameter tree and ``core.carry.load_jax_params`` can load
it.  The layer math stays in plain functions on tensors: ``tree()`` hands
them the parameters as a nested dict.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import engine_for
from repro_torch.models import transformer


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when None.  Never falls back to the CPU:
    asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


class _Tree(nn.Module):
    """A dict level of the parameter tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Model(_Tree):
    """The dense-family model for ``cfg``, weights drawn from ``seed`` on the
    CPU and placed on ``device`` (the card unless the caller asks for the
    CPU).  ``model(batch)`` is the teacher-forced forward; serving goes
    through ``init_cache`` / ``prefill`` / ``decode_step`` with an explicit
    params tree (``tree()`` or its ``cache_weights`` snapshot)::

        model = build(cfg, seed=0, device="cpu")
        cache = model.init_cache(8, 64)
        logits, cache = model.prefill(model.tree(), {"tokens": ids}, cache)
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        gen = torch.Generator().manual_seed(seed)
        params = transformer.init(gen, cfg)
        dev = resolve_device(device)
        super().__init__(_to(params, dev))
        self.cfg = cfg
        self.device = dev

    def forward(self, batch: dict, phase: str = "train") -> torch.Tensor:
        return transformer.forward(self.tree(), batch, self.cfg, phase=phase)

    def forward_hidden(self, batch: dict, phase: str = "train") -> torch.Tensor:
        return transformer.forward_hidden(self.tree(), batch, self.cfg, phase=phase)

    def logits_head(self, hidden: torch.Tensor, phase: str = "train") -> torch.Tensor:
        return transformer.logits_head(self.tree(), hidden, self.cfg, phase=phase)

    def init_cache(self, batch: int, max_len: int, **kw) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, device=self.device, **kw)

    def prefill(self, params, batch, cache, phase: str = "prefill"):
        return transformer.prefill(params, batch, cache, self.cfg, phase=phase)

    def decode_step(self, params, tokens, cache, phase: str = "decode"):
        return transformer.decode_step(params, tokens, cache, self.cfg, phase=phase)

    def cache_weights(self, params: dict) -> dict:
        """Serving-time weight cache: contract decode-``cached`` matrices to
        dense W once (see ``MPOEngine.cache_weights``)."""
        return engine_for(self.cfg.mpo).cache_weights(params)


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def build(cfg: ModelConfig, *, seed: int = 0, device=None) -> Model:
    """The model for ``cfg``; the dense family only in this slice (the others
    raise, ROADMAP.md Queue 1 item 12)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} comes with ROADMAP.md, Queue 1 item 12")
    return Model(cfg, seed=seed, device=device)

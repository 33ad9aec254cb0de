"""``Model``: a model family as an ``nn.Module`` — the port of
``repro.models.model``.  ``build`` dispatches by family: ``dense``,
``moe`` and ``vlm`` to ``models.transformer``, ``ssm`` to ``models.mamba``,
``hybrid`` to ``models.zamba``, ``encdec`` to ``models.whisper``.

Parameters are registered under the reference's key paths
(``embed.cores.c0``, ``layers.attn.wq.cores.central``, ``layers.ln1.scale``,
``layers.in_proj.cores.c0``, …) with the stacked leading layer dim kept, so
``state_dict()`` keys match the reference's parameter tree and
``core.carry.load_jax_params`` can load it.  The layer math stays in plain
functions on tensors: ``tree()`` hands them the parameters as a nested dict,
and ``set_tree`` installs one (the MPO cores may change their bonds, as
conversion and squeezing change them).
"""

from __future__ import annotations

import contextlib
from typing import Iterable

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import engine_for
from repro_torch.core.layers import axes_for
from repro_torch.models import mamba, transformer, whisper, zamba

# family -> module of its init / forward / serving functions: every family
# of the reference
FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer, "ssm": mamba,
            "hybrid": zamba, "encdec": whisper}


def resolve_device(device=None) -> torch.device:
    """``device``, or the card when None.  Never falls back to the CPU:
    asking for the card where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


@contextlib.contextmanager
def differentiable(params: Iterable[torch.Tensor]):
    """Turn on ``requires_grad`` for ``params`` inside the block, off again
    after it.  Parameters are registered without it, so serving builds no
    graph; the train step differentiates inside this block, and the
    optimizer then updates the parameters in place under ``no_grad``."""
    params = list(params)
    for p in params:
        p.requires_grad_(True)
    try:
        yield params
    finally:
        for p in params:
            p.requires_grad_(False)


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

    def _install(self, tree: dict, device):
        for k, v in tree.items():
            if isinstance(v, dict):
                self._modules[k]._install(v, device)
                continue
            p = self._parameters[k]
            if tuple(v.shape) == tuple(p.shape):
                p.copy_(v)
            else:       # a core whose bonds changed: a new parameter of its shape
                self.register_parameter(k, nn.Parameter(v.to(device, copy=True),
                                                        requires_grad=False))


class Model(_Tree):
    """The model of ``cfg``'s family, weights drawn from ``seed`` on the
    CPU and placed on ``device`` (the card unless the caller asks for the
    CPU).  ``init_device="cuda"`` draws them on the card instead: other
    draws from the same seed, in a fraction of the time a full-width model
    takes on the CPU.  ``model(batch)`` is the teacher-forced forward;
    serving goes through ``init_cache`` / ``prefill`` / ``decode_step`` with
    an explicit params tree (``tree()`` or its ``cache_weights`` snapshot)::

        model = build(cfg, seed=0, device="cpu")
        cache = model.init_cache(8, 64)
        logits, cache = model.prefill(model.tree(), {"tokens": ids}, cache)
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None, init_device="cpu"):
        mod = family_module(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=resolve_device(init_device)).manual_seed(seed)
        params = mod.init(gen, cfg)
        super().__init__(_to(params, dev))
        self.cfg = cfg
        self.device = dev
        self.mod = mod

    @property
    def axes(self) -> dict:
        """The logical-axis tree of the parameters (the reference's
        ``model.init_params(key)[1]``), which ``parallel.sharding`` maps
        onto a mesh; from the config alone (``layers.axes_for``)."""
        return axes_for(self.cfg)

    def forward(self, batch: dict, phase: str = "train", **kw) -> torch.Tensor:
        """Logits; the transformer families take ``with_aux=True`` for
        ``(logits, MoE load-balance loss)``."""
        return self.mod.forward(self.tree(), batch, self.cfg, phase=phase, **kw)

    def forward_hidden(self, batch: dict, phase: str = "train") -> torch.Tensor:
        return self.mod.forward_hidden(self.tree(), batch, self.cfg, phase=phase)

    def logits_head(self, hidden: torch.Tensor, phase: str = "train") -> torch.Tensor:
        return self.mod.logits_head(self.tree(), hidden, self.cfg, phase=phase)

    def init_cache(self, batch: int, max_len: int, **kw):
        """The serving cache: the KV cache (a dict; ``paged=True`` pages it)
        for the transformer families, the ``(L, B, H, N, P)`` f32 state
        tensor for ``ssm``, for ``hybrid`` a dict of both (``kv``: one dense
        cache a segment, ``ssm``: the states), and for ``encdec`` the
        decoder's dense self-attention cache and the encoder's output
        (``self``: ``k``, ``v`` (L, B, max_len, KV, Dh) and ``pos`` (L,);
        ``enc_out``: (B, frontend_len, d_model)); none of the last three
        pages (``paged=True`` raises)."""
        return self.mod.init_cache(self.cfg, batch, max_len, device=self.device, **kw)

    def reset_cache(self, cache):
        """Rewind a cache made by ``init_cache`` to its initial contents in
        place, allocating nothing."""
        return self.mod.reset_cache(cache)

    def prefill(self, params, batch, cache, phase: str = "prefill"):
        return self.mod.prefill(params, batch, cache, self.cfg, phase=phase)

    def decode_step(self, params, tokens, cache, phase: str = "decode"):
        return self.mod.decode_step(params, tokens, cache, self.cfg, phase=phase)

    @property
    def prefill_chunk(self):
        """Incremental prefill, ``(params, batch, cache, phase="prefill") ->
        (all-position logits, cache)``: one chunk at the cache's current
        offset (``transformer.prefill_chunk``).  ``None`` for the ``ssm``,
        ``hybrid`` and ``encdec`` families, whose caches have no per-slot KV
        sequence to continue (the reference has none for them)."""
        fn = getattr(self.mod, "prefill_chunk", None)
        if fn is None:
            return None
        cfg = self.cfg
        return lambda params, batch, cache, phase="prefill": fn(params, batch, cache, cfg,
                                                                phase=phase)

    @torch.no_grad()
    def set_tree(self, tree: dict) -> "Model":
        """Install ``tree`` (a nested dict of tensors under the model's key
        paths) as the parameters, on the model's device.  A leaf of the same
        shape is copied into its parameter; an MPO core leaf (under a
        ``cores`` dict) may change its bonds — its leading stack dims and
        i/j legs stay — and replaces its parameter.  Any other difference
        in key, shape or dtype raises before anything is written."""
        src, dst = _flatten(tree), dict(self.named_parameters())
        missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
        if missing or extra:
            raise KeyError(f"parameter trees differ: missing {missing}, extra {extra}")
        for name, p in dst.items():
            t = src[name]
            same = tuple(t.shape) == tuple(p.shape)
            core = ".cores." in f".{name}" and t.dim() == p.dim() >= 4
            bonds_only = core and t.shape[:-4] == p.shape[:-4] and t.shape[-3:-1] == p.shape[-3:-1]
            if t.dtype != p.dtype or not (same or bonds_only):
                raise ValueError(f"{name}: the tree has {tuple(t.shape)} {t.dtype}, the model "
                                 f"{tuple(p.shape)} {p.dtype} (only an MPO core's bonds may "
                                 "change)")
        self._install(tree, self.device)
        return self

    def cache_weights(self, params: dict, *, axes=None):
        """Serving-time weight cache: contract decode-``cached`` matrices to
        dense W once, in the config's activation dtype (see
        ``MPOEngine.cache_weights``).  With ``axes`` returns ``(params,
        axes)``: the dense W inherits its cores' tensor-parallel layout."""
        return engine_for(self.cfg.mpo).cache_weights(params, dtype=self.cfg.torch_dtype,
                                                      axes=axes)


def _flatten(tree: dict, prefix: str = "") -> dict:
    """{dotted key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _to(tree: dict, device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def family_module(cfg: ModelConfig):
    """The module of ``cfg``'s family; an unknown family raises the
    reference's ``ValueError``."""
    mod = FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown family {cfg.family}")
    return mod


def build(cfg: ModelConfig, *, seed: int = 0, device=None, init_device="cpu") -> Model:
    """The model for ``cfg``, of any of the reference's families."""
    return Model(cfg, seed=seed, device=device, init_device=init_device)

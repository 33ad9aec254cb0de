"""The serving weight cache in the activation dtype (``MPOEngine.cache_weights``
with ``dtype=``; ``Model.cache_weights`` and ``init_serve`` pass the
config's): a bf16 handle holds bf16 W whose logits and tokens are bit for
bit those of a float32-cached tree cast at every use, a stacked matrix is
contracted one layer at a time into one preallocated tensor, and float32
handles hold what they held before (a stack of per-layer ``reconstruct``
results, the old contraction).  Pure PyTorch on the CPU, smoke configs."""

import math

import numpy as np
import pytest
import torch

from repro_torch import Session, configs
from repro_torch.core import layers as L
from repro_torch.core import mpo
from repro_torch.core import squeeze as SQ
from repro_torch.core.engine import engine_for
from repro_torch.train.steps import make_serve_steps

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCHS = ("bert-base", "albert-base", "qwen3-14b", "gemma2-27b", "mamba2-130m")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacked(cores):
    """The stacked contraction as it was made before the repair: each
    layer's ``reconstruct`` (a contiguous copy in the cores' dtype), then
    ``torch.stack``."""
    if cores[0].dim() == 4:
        return mpo.reconstruct(cores)
    return torch.stack([_stacked([c[i] for c in cores]) for i in range(cores[0].shape[0])])


def _cached(session, handle):
    """{path: (cores, cached W)} of every matrix the handle densified."""
    out = {}
    for path, cd in SQ.find_mpo_layers(session.params).items():
        node = _at(handle.params, path[:-1])
        if "w" in node:
            out[path] = (L.cores_to_list(cd), node["w"])
    return out


@pytest.mark.parametrize("n,dtype", [(1, torch.float32), (2, torch.bfloat16),
                                     (5, torch.float32), (5, torch.bfloat16)])
def test_reconstruct_into_is_reconstruct_rounded_once(n, dtype):
    gen = torch.Generator().manual_seed(n)
    spec = mpo.MPOSpec.make(48, 80, n=n, bond_dim=6)
    cores = mpo.init_cores(gen, spec)
    out = torch.full((48, 80), float("nan"), dtype=dtype)
    assert mpo.reconstruct_into(cores, out) is out
    assert torch.equal(out, mpo.reconstruct(cores).to(dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_handle_caches_bf16_and_matches_float32_cast_at_use(arch):
    """The bf16 handle's cached leaves are bf16 and equal the float32
    contraction rounded once; its prefill and decode logits and greedy
    tokens are bit for bit those of the float32-cached tree, which the
    engine casts to bf16 at every use (the behaviour before the repair)."""
    cfg = configs.smoke_config(arch, dtype="bfloat16")
    s = Session.init(cfg, seed=3, device="cpu")
    kw = {} if cfg.family == "ssm" else {"paged": True}
    handle = s.serve(2, 32, weight_cache=True, **kw)
    cached = _cached(s, handle)
    assert cached
    for path, (cores, w) in cached.items():
        assert w.dtype == torch.bfloat16, path
        assert torch.equal(w, _stacked(cores).to(torch.bfloat16)), path
    f32_tree = engine_for(cfg.mpo).cache_weights(s.params)          # dtype=None: float32
    assert all(_at(f32_tree, p[:-1])["w"].dtype == torch.float32 for p in cached)
    prefill, decode, init_serve, _ = make_serve_steps(s.model, weight_cache=False, **kw)
    params, cache = init_serve(f32_tree, 2, 32)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        want = prefill(params, {"tokens": prompts}, cache)[0]
        got = handle.prefill({"tokens": prompts})
        assert got.dtype == want.dtype == torch.bfloat16
        assert torch.equal(got, want)
        tok = torch.argmax(want[:, -1], -1)[:, None].to(torch.int32)
        for _ in range(4):
            want_tok, want, cache = decode(params, tok, cache)
            got_tok, got = handle.decode(tok)
            assert torch.equal(got, want) and torch.equal(got_tok, want_tok)
            tok = want_tok


def test_stacked_matrix_is_contracted_one_layer_at_a_time(monkeypatch):
    """Each layer of a stack goes through ``reconstruct_into`` on its own,
    into its slice of one (L, I, J) tensor in the activation dtype: no
    float32 stack is ever made."""
    cfg = configs.smoke_config("bert-base", dtype="bfloat16", num_layers=3)
    s = Session.init(cfg, seed=0, device="cpu")
    calls = []
    into = mpo.reconstruct_into

    def counted(cores, out):
        assert all(c.dim() == 4 for c in cores) and out.dim() == 2
        calls.append((tuple(tuple(c.shape) for c in cores), out.dtype, out.data_ptr()))
        return into(cores, out)

    monkeypatch.setattr(mpo, "reconstruct_into", counted)
    tree = s.model.cache_weights(s.params)
    want = 0
    for path, cd in SQ.find_mpo_layers(s.params).items():
        node = _at(tree, path[:-1])
        if "w" not in node:
            continue
        lead = L.cores_to_list(cd)[0].shape[:-4]
        want += math.prod(lead)
        w = node["w"]
        assert w.dtype == torch.bfloat16 and w.shape[:-2] == lead
        if lead:       # every layer written into its own slice of one tensor
            ptrs = {p for _, _, p in calls if w.data_ptr() <= p < w.data_ptr()
                    + w.numel() * w.element_size()}
            assert len(ptrs) == lead[0] == cfg.num_layers
    assert len(calls) == want > cfg.num_layers
    assert {dt for _, dt, _ in calls} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ["bert-base", "mamba2-130m"])
def test_float32_handle_is_unchanged(arch):
    """A float32 handle caches float32 W with the bits of the stacked
    contraction it held before the repair."""
    s = Session.init(arch, seed=1, device="cpu")
    assert s.cfg.dtype == "float32"
    cached = _cached(s, s.serve(2, 32, weight_cache=True))
    assert cached
    for path, (cores, w) in cached.items():
        assert w.dtype == torch.float32
        assert torch.equal(w, _stacked(cores)), path

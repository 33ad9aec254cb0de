"""The port's dense model and serving path (``repro_torch.models`` /
``train.steps`` / ``pipeline.session``) against the JAX package, with the
reference's weights loaded through ``core.carry.load_jax_params``.

Float32 throughout: logits of the 2-layer smoke models agree to ~1e-6
relative (1e-4 allowed: sums in another order across two frameworks), and
greedy tokens must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import layers as JL
from repro.models import model as JModel
from repro.models import nn as JNN
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel
from repro_torch.models import nn as TNN
from repro_torch.pipeline.session import compression_ratio

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCHS = ("bert-base", "qwen3-14b", "albert-base", "gemma2-27b", "mistral-nemo-12b",
         "nemotron-4-15b")
TOL = 1e-4


def _np_tree(params):
    return jax.tree.map(lambda a: np.array(a), params)


def _weights(arch):
    """Smoke weights under the reference's key paths, as numpy: drawn by
    the port (the reference's own init compiles for seconds per config)
    and checked against the reference's abstract parameter tree."""
    src = TModel.build(tconfigs.smoke_config(arch), seed=7, device="cpu")
    tree = _np_tree(src.tree())
    abstract, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.smoke_config(arch)).init, jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference Session, port Session) over the same smoke weights, given
    to the port through ``load_jax_params``."""
    arch = request.param
    tree = _weights(arch)
    js = JSession(jconfigs.smoke_config(arch), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(arch, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _prompts(cfg, b=3, s=7, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_state_dict_keys_are_reference_key_paths(pair):
    js, ts = pair
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    ref = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == ref


def test_forward_matches_reference(pair):
    js, ts = pair
    tokens = _prompts(js.cfg, 2, 9)
    jl, _ = js.model.forward(js.params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl = ts.model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits_match(pair, paged):
    js, ts = pair
    prompts = _prompts(js.cfg, s=14)
    jh = js.serve(3, 32, paged=paged, weight_cache=False)
    th = ts.serve(3, 32, paged=paged, weight_cache=False)
    jl = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}))
    tl = th.prefill({"tokens": prompts})
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=TOL)
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(3):      # crosses the 16-token page boundary
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    for k, v in th.cache.items():       # the caches themselves agree too
        np.testing.assert_allclose(v.float().numpy(), np.asarray(jh.cache[k], np.float32),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("weight_cache", [True, False])
def test_greedy_generation_identical(pair, paged, weight_cache):
    js, ts = pair
    prompts = _prompts(js.cfg, s=14, seed=1)
    jo = js.serve(3, 32, paged=paged, weight_cache=weight_cache).generate(
        {"tokens": jnp.asarray(prompts)}, 12)
    th = ts.serve(3, 32, paged=paged, weight_cache=weight_cache)
    to = th.generate({"tokens": prompts}, 12)
    assert to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # a second generate on the reused handle starts from an empty cache
    np.testing.assert_array_equal(ts.serve(3, 32, paged=paged, weight_cache=weight_cache)
                                  .generate({"tokens": prompts}, 12).numpy(), np.asarray(jo))


def test_norms_rope_and_masks_match():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    pos = np.array([[0, 3, 7, 8, 31]], np.int32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (JNN.apply_rmsnorm({"scale": jnp.asarray(scale)}, jx),
         TNN.apply_rmsnorm({"scale": torch.from_numpy(scale)}, tx)),
        (JNN.apply_layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx),
         TNN.apply_layernorm({"scale": torch.from_numpy(scale),
                              "bias": torch.from_numpy(bias)}, tx)),
        (JNN.rope(jx, jnp.asarray(pos), 10000.0),
         TNN.rope(tx, torch.from_numpy(pos), 10000.0)),
        (JNN.rope(jx, jnp.asarray(pos), 1e6), TNN.rope(tx, torch.from_numpy(pos), 1e6)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)
    for kw in ({}, {"window": 3}, {"offset": 2}):
        np.testing.assert_array_equal(TNN.causal_mask(4, 9, **kw).numpy(),
                                      np.asarray(JNN.causal_mask(4, 9, **kw)))


# --------------------------------------------------------------------------
# paged / dense cache appends, including the out-of-range cases
# --------------------------------------------------------------------------


def _paged_cache(b, mp, ps, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    pool = b * mp
    return {"k_pages": rng.standard_normal((pool, ps, kv, dh)).astype(np.float32),
            "v_pages": rng.standard_normal((pool, ps, kv, dh)).astype(np.float32),
            "page_table": np.full((b, mp), -1, np.int32),
            "pos": np.zeros((b,), np.int32),
            "free_list": rng.permutation(pool).astype(np.int32),
            "free_count": np.array(pool, np.int32)}


def _t(cache):
    return {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}


def _assert_cache_equal(tc, jc):
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)


def test_paged_appends_match_reference_bit_for_bit():
    b, mp, ps, kv, dh = 3, 3, 4, 2, 5
    rng = np.random.default_rng(1)
    jc = _paged_cache(b, mp, ps, kv, dh)
    tc = _t(jc)
    k = rng.standard_normal((b, 6, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, 6, kv, dh)).astype(np.float32)
    jc = JNN._paged_prefill_append({kk: jnp.asarray(x) for kk, x in jc.items()},
                                   jnp.asarray(k), jnp.asarray(v))
    TNN._paged_prefill_append(tc, torch.from_numpy(k), torch.from_numpy(v))
    _assert_cache_equal(tc, jc)
    # decode appends: slot 1 parked past capacity (never writes, never
    # allocates), page boundaries crossed at pos 8, steps where no slot
    # allocates (rank -1 everywhere)
    jc = dict(jc, pos=jc["pos"].at[1].set(mp * ps))
    tc["pos"][1] = mp * ps
    for step in range(6):
        k1 = rng.standard_normal((b, 1, kv, dh)).astype(np.float32)
        v1 = rng.standard_normal((b, 1, kv, dh)).astype(np.float32)
        jc = JNN._paged_decode_append(jc, jnp.asarray(k1), jnp.asarray(v1))
        TNN._paged_decode_append(tc, torch.from_numpy(k1), torch.from_numpy(v1))
        _assert_cache_equal(tc, jc)
    assert int(tc["pos"][1]) == mp * ps + 6          # advanced, wrote nothing


def test_paged_decode_append_drops_with_row_zero_collision():
    """A dropped (past-capacity) write and a kept write to physical row 0 in
    the same step: the kept one wins, as in the reference."""
    b, mp, ps, kv, dh = 2, 2, 2, 1, 3
    jc = _paged_cache(b, mp, ps, kv, dh)
    jc["free_list"] = np.arange(b * mp, dtype=np.int32)[::-1].copy()   # pops page 0 first
    jc["pos"] = np.array([0, mp * ps], np.int32)
    tc = _t(jc)
    k1 = np.ones((b, 1, kv, dh), np.float32) * np.array([7.0, 9.0])[:, None, None, None]
    jout = JNN._paged_decode_append({kk: jnp.asarray(x) for kk, x in jc.items()},
                                    jnp.asarray(k1), jnp.asarray(k1))
    TNN._paged_decode_append(tc, torch.from_numpy(k1), torch.from_numpy(k1))
    _assert_cache_equal(tc, jout)
    assert float(tc["k_pages"][0, 0, 0, 0]) == 7.0


def test_dense_decode_write_past_max_len_is_dropped(pair):
    js, ts = pair
    th = ts.serve(3, 16, weight_cache=True)
    jh = js.serve(3, 16, weight_cache=True)
    prompts = _prompts(js.cfg, s=5)
    th.prefill({"tokens": prompts})
    jh.prefill({"tokens": jnp.asarray(prompts)})
    # park slot 2 past the end of the ring buffer
    th.cache["pos"][:, 2] = 16
    jh.cache = dict(jh.cache, pos=jh.cache["pos"].at[:, 2].set(16))
    tok = np.ones((3, 1), np.int32)
    _, tl = th.decode(tok)
    _, jl = jh.decode(jnp.asarray(tok))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for k in ("k", "v", "pos"):
        np.testing.assert_allclose(th.cache[k].numpy(), np.asarray(jh.cache[k]), atol=TOL)


# --------------------------------------------------------------------------
# loading, sessions, devices
# --------------------------------------------------------------------------


def test_load_jax_params_rejects_mismatches(pair):
    js, ts = pair
    tree = _np_tree(js.params)
    bad = dict(tree, extra={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(ts.model, bad)
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(ts.model, bad)
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_jax_params(ts.model, bad)
    bad = dict(tree, final_norm={"scale": tree["final_norm"]["scale"].astype(np.float64)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_jax_params(ts.model, bad)


def test_report_and_later_stages(pair):
    js, ts = pair
    rep = ts.report()
    assert rep["arch"] == js.cfg.name and rep["stage"] in ("init", "serve")
    assert rep["params_total"] == sum(int(np.prod(x.shape))
                                      for x in jax.tree.leaves(js.params))
    cores = [t for k, t in ts.model.state_dict().items() if ".cores." in k]
    assert 0 < rep["compression_ratio"] < 1
    assert rep["compression_ratio"] == compression_ratio(ts.params)
    assert sum(c.numel() for c in cores) < rep["params_total"]
    # finetune, from_dense, squeeze, persistence and the serving front end
    # are ported (tests/test_torch_train.py, tests/test_torch_lifecycle.py,
    # tests/test_torch_persistence.py, tests/test_torch_serve_pool.py,
    # tests/test_torch_router.py), and serving over a mesh
    # (tests/test_torch_mesh.py), which a session built without the
    # logical-axis tree refuses, as the reference's does
    fresh = TSession.init(ts.cfg, device="cpu")
    rep = fresh.finetune(steps=1, seq_len=8, batch_size=2)
    assert {"trainable", "reduction", "loss_first", "loss_final", "history"} <= set(rep)
    assert fresh.report()["stage"] == "finetune"
    assert ts.axes == ts.model.axes
    raw = TSession(ts.cfg, ts.model)
    standin = type("Mesh", (), {"mesh_dim_names": ("data", "model"), "shape": (1, 1)})()
    for call in (lambda: raw.serve(2, 16, mesh=standin),
                 lambda: raw.serve_pool(2, 16, mesh=standin),
                 lambda: raw.serve_fleet(2, 2, 16, mesh=standin)):
        with pytest.raises(ValueError, match="logical-axis tree"):
            call()


def test_other_families_raise():
    # every family of the reference is ported (tests/test_torch_mamba.py,
    # test_torch_moe.py, test_torch_vlm.py, test_torch_zamba.py,
    # test_torch_whisper.py) and every arch resolves; an unknown family
    # raises the reference's ValueError, an unknown arch a KeyError
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        assert TModel.family_module(tconfigs.get_config(arch)) is \
            TModel.FAMILIES[jconfigs.get_config(arch).family], arch
    cfg = dataclasses.replace(tconfigs.smoke_config("bert-base"), family="audio")
    with pytest.raises(ValueError, match="unknown family audio"):
        TModel.build(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown family audio"):
        JModel.build(dataclasses.replace(jconfigs.smoke_config("bert-base"), family="audio"))
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("whisper-base")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert TSession.init("bert-base").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSession.init("bert-base")

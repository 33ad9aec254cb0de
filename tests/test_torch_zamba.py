"""The port's hybrid family (``repro_torch.models.zamba``, zamba2-7b) against
the JAX package's ``repro.models.zamba``, from one weight tree drawn by the
port and carried into both through numpy (``core.carry.load_jax_params``).

Smoke zamba2-7b at 6 layers: 3 segments of 2 Mamba2 blocks over 2 shared
attention blocks, so shared block 0 serves segments 0 and 2 (the default
smoke depth of 4 would use each block once and miss a dropped reuse).  The
SSD vectors are redrawn away from their constant init so that the decays
differ per head.

Float32 throughout, summed in another order by two frameworks: logits agree
to ~1e-6 relative (2e-4 allowed, as ``tests/test_torch_engine.py``); cache
states and a shared block's output are held to the same; greedy tokens must
be identical; gradients of every leaf within 2e-4 of their largest
magnitude with every matmul factorized (``tests/test_torch_train.py``'s)."""

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
from repro.models import transformer as JT
from repro.models import zamba as JZ
from repro.train import steps as JSteps
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import load_jax_params
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import model as TModel
from repro_torch.models import nn as TNN
from repro_torch.models import transformer as TT
from repro_torch.models import zamba as TZ
from repro_torch.optim import optimizers as TOpt
from repro_torch.pipeline.scheduler import ServePool
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH, LAYERS = "zamba2-7b", 6
TOL = 2e-4


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.array(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _weights(tcfg, jcfg, seed=7):
    """Smoke weights under the reference's key paths, as numpy, checked
    against the reference's abstract tree (nothing drawn by JAX)."""
    tree = jax.tree.map(lambda t: np.array(t), TModel.build(tcfg, seed=seed, device="cpu").tree())
    rng = np.random.default_rng(seed)
    lay = tree["mamba"]
    lay["a_log"] = (rng.standard_normal(lay["a_log"].shape) * 0.5).astype(np.float32)
    lay["dt_bias"] = (rng.standard_normal(lay["dt_bias"].shape) * 0.5).astype(np.float32)
    lay["d_skip"] = (1 + rng.standard_normal(lay["d_skip"].shape) * 0.1).astype(np.float32)
    abstract, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    return tree


@pytest.fixture(scope="module")
def pair():
    """(reference Session, port Session) over the same smoke weights."""
    tcfg = tconfigs.smoke_config(ARCH, num_layers=LAYERS)
    jcfg = jconfigs.smoke_config(ARCH, num_layers=LAYERS)
    tree = _weights(tcfg, jcfg)
    js = JSession(jcfg, jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(tcfg, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _prompts(cfg, b=3, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_segments_and_keys_match_reference(pair):
    js, ts = pair
    full_t, full_j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert (full_t.d_inner, full_t.ssm_heads, TZ.num_segments(full_t)) == (7168, 112, 9)
    assert TZ.num_segments(ts.cfg) == JZ._num_segments(js.cfg) == 3
    assert ts.cfg.num_shared_attn == 2 and ts.cfg.attn_every == 2
    assert TModel.build(ts.cfg, device="cpu").mod is TZ
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    ref = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == ref
    assert ts.model.shared_attn.attn.wq.cores.c0.shape[0] == 2
    assert ts.model.mamba.in_proj.cores.c0.shape[0] == LAYERS
    with pytest.raises(ValueError, match="multiple of attn_every"):
        TZ.num_segments(dataclasses.replace(ts.cfg, num_layers=5))


def test_shared_block_past_num_shared_matches_reference(pair):
    """Segment 2 takes shared block 0 (``2 % num_shared_attn``): its output
    is block 0's, not block 1's, in both packages."""
    js, ts = pair
    x = np.random.default_rng(5).standard_normal((2, 10, ts.cfg.d_model)).astype(np.float32)
    pos = np.arange(10)[None, :]
    jy, _ = JZ._shared_attn_fwd(js.cfg, js.params["shared_attn"], 2, jnp.asarray(x),
                                positions=jnp.asarray(pos), mask=JNN.causal_mask(10, 10))
    with torch.no_grad():
        ty = {i: TZ._shared_attn_fwd(ts.cfg, ts.params["shared_attn"], i, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos),
                                     mask=TNN.causal_mask(10, 10)) for i in (0, 1, 2)}
    _close(ty[2].numpy(), jy)
    torch.testing.assert_close(ty[2], ty[0], rtol=0, atol=0)
    assert not torch.allclose(ty[1], ty[0])


def test_forward_matches_reference(pair):
    js, ts = pair
    tokens = _prompts(js.cfg, 2, 32)
    jl, aux = js.model.forward(js.params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl = ts.model({"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0 and tuple(tl.shape) == (2, 32, js.cfg.vocab_size)
    _close(tl.numpy(), jl)


@pytest.mark.parametrize("prompt", [32, 12])     # two chunks; one chunk shorter than 16
def test_prefill_and_decode_logits_and_cache_match(pair, prompt):
    """Prefill, then 4 decode steps: logits, every segment's K/V and
    position, and every layer's SSM state."""
    js, ts = pair
    prompts = _prompts(js.cfg, s=prompt)
    jh = js.serve(3, 40, weight_cache=False)
    th = ts.serve(3, 40, weight_cache=False)
    jl = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}))
    tl = th.prefill({"tokens": prompts})
    assert tuple(tl.shape) == (3, 1, js.cfg.vocab_size)
    _close(tl.numpy(), jl)

    def same_cache():
        assert set(th.cache) == {"kv", "ssm"} and set(th.cache["kv"]) == {"k", "v", "pos"}
        assert th.cache["kv"]["pos"].shape == (TZ.num_segments(ts.cfg),)
        assert th.cache["kv"]["pos"].dtype == torch.int32
        np.testing.assert_array_equal(th.cache["kv"]["pos"].numpy(),
                                      np.asarray(jh.cache["kv"]["pos"]))
        for k in ("k", "v"):
            _close(th.cache["kv"][k].numpy(), jh.cache["kv"][k])
        _close(th.cache["ssm"].numpy(), jh.cache["ssm"])

    same_cache()
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(4):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        _close(tl.numpy(), jl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    same_cache()
    assert int(th.cache["kv"]["pos"][0]) == prompt + 4


def test_scalar_position_cache_writes_match_reference(pair):
    """``apply_attention`` over a dense cache with a 0-d ``pos``: a
    multi-token write at ``pos``, one-token writes, and a write past
    ``max_len``, which the reference's ``dynamic_update_slice`` clamps so
    that it overwrites the last row; the port clamps the same way."""
    js, ts = pair
    acfg_t, acfg_j = TT.attn_cfg(ts.cfg), JT.attn_cfg(js.cfg)
    tparams = TNN.index_layer(ts.params["shared_attn"], 1)["attn"]
    jparams = jax.tree.map(lambda a: a[1], js.params["shared_attn"])["attn"]
    max_len, kvh, dh = 8, ts.cfg.num_kv_heads, ts.cfg.head_dim
    rng = np.random.default_rng(9)
    k0 = rng.standard_normal((2, max_len, kvh, dh)).astype(np.float32)
    v0 = rng.standard_normal((2, max_len, kvh, dh)).astype(np.float32)
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy()),
              "pos": torch.tensor(0, dtype=torch.int32)}
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.int32(0)}
    for s, at in ((3, 2), (1, 5), (1, 7), (1, 8), (2, 12)):   # the last two past the end
        tcache["pos"].fill_(at)
        jcache["pos"] = jnp.int32(at)
        x = rng.standard_normal((2, s, ts.cfg.d_model)).astype(np.float32)
        pos = at + np.arange(s)[None, :]
        mask = np.ones((1, 1, s, max_len), bool)
        jy, jcache = JNN.apply_attention(jparams, jnp.asarray(x), acfg_j, js.cfg.mpo,
                                         positions=jnp.asarray(pos), mask=jnp.asarray(mask),
                                         cache=jcache, phase="decode")
        with torch.no_grad():
            ty, out = TNN.apply_attention(tparams, torch.from_numpy(x), acfg_t, ts.cfg.mpo,
                                          positions=torch.from_numpy(pos),
                                          mask=torch.from_numpy(mask), cache=tcache,
                                          phase="decode")
        assert out is tcache and tcache["pos"].dim() == 0
        assert int(tcache["pos"]) == int(jcache["pos"]) == at + s
        for k in ("k", "v"):
            _close(tcache[k].numpy(), jcache[k])
        _close(ty.numpy(), jy)
    # the write at 12 (two rows) landed on rows 6 and 7; the one at 8 on row 7
    assert not np.array_equal(tcache["k"][:, 7].numpy(), k0[:, 7])


def test_paged_cache_and_pool_are_refused(pair):
    js, ts = pair
    with pytest.raises(ValueError, match="not supported for family 'hybrid'"):
        js.model.init_cache(2, 16, paged=True)
    with pytest.raises(ValueError, match="not supported for family 'hybrid'"):
        ts.model.init_cache(2, 16, paged=True)
    with pytest.raises(ValueError, match="not supported for family 'hybrid'"):
        ts.serve(2, 16, paged=True)
    assert ts.model.prefill_chunk is None
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        ServePool(ts.model, ts.params, 2, 16)
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        ts.serve_pool(2, 16)


def test_reset_cache_rewinds_in_place(pair):
    _, ts = pair
    h = ts.serve(2, 32)
    tensors = [h.cache["kv"]["k"], h.cache["kv"]["v"], h.cache["kv"]["pos"], h.cache["ssm"]]
    first = h.generate({"tokens": _prompts(ts.cfg, 2, 10, seed=4)}, 3)
    assert int(h.cache["kv"]["pos"][0]) == 12 and h.cache["ssm"].abs().sum() > 0
    h.reset()
    got = [h.cache["kv"]["k"], h.cache["kv"]["v"], h.cache["kv"]["pos"], h.cache["ssm"]]
    assert all(a is b and not a.any() for a, b in zip(tensors, got))
    torch.testing.assert_close(h.generate({"tokens": _prompts(ts.cfg, 2, 10, seed=4)}, 3),
                               first, rtol=0, atol=0)


@pytest.mark.parametrize("weight_cache", [True, False])
def test_greedy_generation_identical(pair, weight_cache):
    js, ts = pair
    prompts = _prompts(js.cfg, s=16, seed=1)
    jo = js.serve(3, 40, weight_cache=weight_cache).generate(
        {"tokens": jnp.asarray(prompts)}, 10)
    to = ts.serve(3, 40, weight_cache=weight_cache).generate({"tokens": prompts}, 10)
    assert to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_lfa_step_grads_match_reference(pair):
    """One train step's gradients of every leaf (factorized matmuls) against
    ``jax.grad`` of the reference's loss: the shared blocks' gradients sum
    their uses (block 0 serves two segments), each Mamba2 layer's SSD scan
    runs its backward's plain version once (remat recomputes nothing here:
    the smoke config has it off, and then with it on, the same bits)."""
    js, ts = pair
    mpo = dict(mode="factorized")
    jcfg = dataclasses.replace(js.cfg, mpo=dataclasses.replace(js.cfg.mpo, **mpo))
    jm = JModel.build(jcfg)
    batch = ts._default_batch_fn(16, 4, 0)(0)
    jb = jax.tree.map(jnp.asarray, batch)
    (_, jmet), jg = jax.jit(jax.value_and_grad(lambda p: JSteps.lm_loss(jm, p, jb),
                                               has_aux=True))(js.params)
    jg = _flat(jg)
    grads = {}
    for remat in (False, True):
        tcfg = dataclasses.replace(ts.cfg, remat=remat,
                                   mpo=dataclasses.replace(ts.cfg.mpo, **mpo))
        model = TModel.build(tcfg, device="cpu")
        model.set_tree(ts.params)
        seen = []
        opt = TOpt.Optimizer(init=lambda p: TOpt.OptState(0, None),
                             update=lambda g, s, p: seen.append(g) or s)
        step = TSteps.make_train_step(model, opt)
        calls = TSSD.ssd_scan_bwd_plain.calls
        _, tmet = step(TSteps.TrainState(model.tree(), opt.init(model.tree())),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
        assert TSSD.ssd_scan_bwd_plain.calls == calls + LAYERS
        grads[remat] = _flat(seen[0])
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=TOL)
    assert set(grads[False]) == set(jg)
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        np.testing.assert_allclose(grads[False][k], jg[k], atol=TOL * scale, rtol=TOL,
                                   err_msg=k)
        np.testing.assert_array_equal(grads[True][k], grads[False][k], err_msg=k)
    # the shared blocks' gradients are the sum of their uses: block 0's
    # (two segments) is not what one use gives
    assert np.abs(jg["shared_attn.attn.wq.cores.c0"][0]).max() > 0
    assert np.abs(jg["shared_attn.attn.wq.cores.c0"][1]).max() > 0


def test_compression_ratio_counts_each_shared_block(pair):
    """rho (Eq. 5) counts the shared stack as its 2 stored matrices, each
    Mamba2 layer's matrices as their own (ROADMAP.md, Queue 3 C)."""
    _, ts = pair
    num = den = 0
    for path, cd in TSQ.find_mpo_layers(ts.params).items():
        cs = list(cd.values())
        stack = int(np.prod(cs[0].shape[:-4]))
        assert stack == {"shared_attn": 2, "mamba": LAYERS, "embed": 1}[path[0]], path
        num += sum(c.numel() for c in cs)
        den += stack * int(np.prod([c.shape[-3] for c in cs])) * int(
            np.prod([c.shape[-2] for c in cs]))
    assert TSQ.model_compression_ratio(ts.params) == pytest.approx(num / den, rel=1e-12)

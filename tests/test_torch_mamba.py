"""The port's SSM family (``repro_torch.models.mamba``, mamba2-130m) against
the JAX package's ``repro.models.mamba``, with the reference's weights loaded
through ``core.carry.load_jax_params``.

Float32 throughout.  The SSD scan's plain version and the reference's
``ssd_chunked`` do the same f32 arithmetic in another order: y and the final
state agree to ~1e-6 relative (2e-5 allowed, as ``tests/test_kernels.py``
allows the Pallas kernel against its oracle).  Logits of the 2-layer smoke
model agree to ~1e-6 relative (1e-4 allowed: sums in another order across two
frameworks, as ``tests/test_torch_model.py`` allows); greedy tokens must be
identical.  The SSD vectors (A_log, dt_bias, D) are drawn away from their
constant init so that the decays differ per head."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import engine as JE
from repro.core import layers as JL
from repro.models import mamba as JMB
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import engine as TE
from repro_torch.core.carry import load_jax_params
from repro_torch.core.layers import cores_to_list
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TModel
from repro_torch.models import nn as TNN

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "mamba2-130m"
TOL = 1e-4
SSD_TOL = 2e-5


def _np_tree(params):
    return jax.tree.map(lambda a: np.array(a), params)


def _weights(seed=7):
    """Smoke weights under the reference's key paths, as numpy: drawn by the
    port, the SSD vectors redrawn with numpy, and checked against the
    reference's abstract parameter tree."""
    src = TModel.build(tconfigs.smoke_config(ARCH), seed=seed, device="cpu")
    tree = _np_tree(src.tree())
    rng = np.random.default_rng(seed)
    lay = tree["layers"]
    lay["a_log"] = (rng.standard_normal(lay["a_log"].shape) * 0.5).astype(np.float32)
    lay["dt_bias"] = (rng.standard_normal(lay["dt_bias"].shape) * 0.5).astype(np.float32)
    lay["d_skip"] = (1 + rng.standard_normal(lay["d_skip"].shape) * 0.1).astype(np.float32)
    abstract, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.smoke_config(ARCH)).init, jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    return tree


@pytest.fixture(scope="module")
def pair():
    """(reference Session, port Session) over the same smoke weights."""
    tree = _weights()
    js = JSession(jconfigs.smoke_config(ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _prompts(cfg, b=3, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)   # softplus
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    d = (1 + rng.standard_normal(h) * 0.1).astype(np.float32)
    return x, dt, a_log, bm, cm, d


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32), (128, 128), (100, 128), (12, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """y and the final state against ``ssd_chunked`` (q = s < chunk for the
    last two), and y against the sequential ``ssd_reference``."""
    args = _ssd_inputs(2, s, 3, 8, 16, seed=s)
    jy, jstate = JMB.ssd_chunked(*map(jnp.asarray, args), chunk)
    calls = TSSD.ssd_scan_plain.calls
    ty, tstate = TMB.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert TSSD.ssd_scan_plain.calls == calls + 1          # CPU -> plain version
    assert ty.dtype == torch.float32 and tuple(tstate.shape) == (2, 3, 16, 8)
    _close(ty.numpy(), jy, SSD_TOL)
    _close(tstate.numpy(), jstate, SSD_TOL)
    _close(ty.numpy(), JMB.ssd_reference(*map(jnp.asarray, args)), SSD_TOL)
    # the port's sequential oracle gives the same y and final state
    ry, rstate = TSSD.ssd_scan_ref(*map(torch.from_numpy, args))
    _close(ry.numpy(), TMB.ssd_reference(*map(torch.from_numpy, args)).numpy(), 0.0)
    _close(ry.numpy(), jy, SSD_TOL)
    _close(rstate.numpy(), jstate, SSD_TOL)


def test_segsum_and_decode_step_match_reference():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((2, 3, 9)).astype(np.float32)
    # the two cumulative sums round differently in the last bit; -inf alike
    np.testing.assert_allclose(TMB.segsum(torch.from_numpy(v)).numpy(),
                               np.asarray(JMB.segsum(jnp.asarray(v))), rtol=1e-6, atol=1e-6)
    b, h, p, n = 3, 4, 8, 16
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    a_log = rng.standard_normal(h).astype(np.float32)
    bt, ct = (rng.standard_normal((b, n)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal(h).astype(np.float32)
    args = (state, x, dt, a_log, bt, ct, d)
    js, jy = JMB.ssd_decode_step(*map(jnp.asarray, args))
    ts, ty = TMB.ssd_decode_step(*map(torch.from_numpy, args))
    _close(ts.numpy(), js, 1e-6)
    _close(ty.numpy(), jy, 1e-6)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------


def test_apply_mamba_block_prefill_and_decode_match(pair):
    js, ts = pair
    jlayer = jax.tree.map(lambda a: a[0], js.params["layers"])
    tlayer = TNN.index_layer(ts.params["layers"], 0)
    cfg_j, cfg_t = js.cfg, ts.cfg
    x = np.random.default_rng(5).standard_normal((2, 32, cfg_t.d_model)).astype(np.float32)
    jy, jstate = JMB.apply_mamba_block(jlayer, jnp.asarray(x), cfg_j, phase="prefill")
    with torch.no_grad():
        ty, tstate = TMB.apply_mamba_block(tlayer, torch.from_numpy(x), cfg_t, phase="prefill")
    _close(ty.numpy(), jy, TOL)
    _close(tstate.numpy(), jstate, TOL)
    xt = np.random.default_rng(6).standard_normal((2, 1, cfg_t.d_model)).astype(np.float32)
    jy, jnew = JMB.apply_mamba_block(jlayer, jnp.asarray(xt), cfg_j, state=jstate,
                                     decode=True, phase="decode")
    with torch.no_grad():
        ty, tnew = TMB.apply_mamba_block(tlayer, torch.from_numpy(xt), cfg_t, state=tstate,
                                         decode=True, phase="decode")
    assert tuple(ty.shape) == (2, 1, cfg_t.d_model)
    _close(ty.numpy(), jy, TOL)
    _close(tnew.numpy(), jnew, TOL)


# --------------------------------------------------------------------------
# the model and its serving path
# --------------------------------------------------------------------------


def test_config_and_state_dict_keys_match_reference(pair):
    js, ts = pair
    full_t, full_j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    for f in ("num_layers", "d_model", "vocab_size", "ssm_state", "ssm_head_dim",
              "ssm_chunk", "d_inner", "ssm_heads", "tie_embeddings", "family"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert dataclasses.asdict(full_t.mpo) == dataclasses.asdict(full_j.mpo)
    assert (full_t.d_inner, full_t.ssm_heads, full_t.vocab_size) == (1536, 24, 50432)
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    ref = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == ref


def test_forward_matches_reference(pair):
    js, ts = pair
    tokens = _prompts(js.cfg, 2, 32)
    jl, _ = js.model.forward(js.params, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tl = ts.model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("prompt", [32, 12])     # two chunks; one chunk shorter than 16
def test_prefill_and_decode_logits_match(pair, prompt):
    js, ts = pair
    prompts = _prompts(js.cfg, s=prompt)
    jh = js.serve(3, 64, weight_cache=False)
    th = ts.serve(3, 64, weight_cache=False)
    jl = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}))
    tl = th.prefill({"tokens": prompts})
    assert tuple(tl.shape) == (3, 1, js.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=TOL)
    _close(th.cache.numpy(), jh.cache, TOL)         # each layer's final state
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(3):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    _close(th.cache.numpy(), jh.cache, TOL)


def test_prefill_ignores_the_incoming_state(pair):
    """The reference's prefill starts every layer's scan from zeros."""
    _, ts = pair
    prompts = torch.from_numpy(_prompts(ts.cfg, s=16))
    params = ts.params
    with torch.no_grad():
        ref, s0 = ts.model.prefill(params, {"tokens": prompts}, ts.model.init_cache(3, 16))
        ref, s0 = ref.clone(), s0.clone()
        junk = torch.randn(s0.shape, generator=torch.Generator().manual_seed(0))
        got, s1 = ts.model.prefill(params, {"tokens": prompts}, junk)
    assert s1 is junk                                  # written in place
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(s1, s0, rtol=0, atol=0)


@pytest.mark.parametrize("weight_cache", [True, False])
def test_greedy_generation_identical(pair, weight_cache):
    js, ts = pair
    prompts = _prompts(js.cfg, s=32, seed=1)
    jo = js.serve(3, 64, weight_cache=weight_cache).generate(
        {"tokens": jnp.asarray(prompts)}, 12)
    th = ts.serve(3, 64, weight_cache=weight_cache)
    to = th.generate({"tokens": prompts}, 12)
    assert to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # a second generate on the reused handle starts from a zero state
    np.testing.assert_array_equal(ts.serve(3, 64, weight_cache=weight_cache)
                                  .generate({"tokens": prompts}, 12).numpy(), np.asarray(jo))


def test_evaluate_matches_reference(pair):
    """The held-out LM metric (negative mean loss) runs the forward through
    the family's own module, as the reference's ``lm_loss`` does."""
    js, ts = pair
    kw = dict(num_batches=2, seq_len=32, batch_size=2)
    ref = js.evaluate(**kw)
    got = ts.evaluate(**kw)
    assert got < 0 and abs(got - ref) <= TOL * abs(ref)


def test_bf16_drift_over_depth_is_the_references():
    """Why the card holds the bf16 mamba2-130m prefill layer by layer and not
    end to end: at the full depth of 24 layers the randomly drawn model
    amplifies rounding, in the reference as in the port.  On the smoke
    widths, the same weights, 2 x 64 tokens:

    * end to end, the reference's bf16 logits leave its f32 logits by more
      than 30% (relative norm; ~0.6-0.8 over three seeds), the port's by the
      same within 10% of it, and the port's bf16 stays nearer the reference's
      bf16 than either comes to f32 (within half of that drift); f32 sums in
      another order grow from ~1e-6 at 2 layers to ~1e-4 here (1e-3 allowed);
    * one block at a time, from the same bf16 input: the port's bf16 block
      misses the reference's f32 block by the reference's own bf16 error
      (within 10% of it, ~2% of the block's update), and lies within a
      quarter of that error from the reference's bf16 block (under 5%
      measured)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), num_layers=24)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH), num_layers=24)
    src = TModel.build(tcfg, seed=0, device="cpu")
    tree = _np_tree(src.tree())
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _prompts(tcfg, 2, 64)
    logits = {}
    for dt in ("float32", "bfloat16"):
        jm = JModel.build(dataclasses.replace(jcfg, dtype=dt))
        logits["ref", dt] = np.asarray(jm.forward(jparams, {"tokens": jnp.asarray(tokens)})[0],
                                       np.float32)
        tm = load_jax_params(TModel.build(dataclasses.replace(tcfg, dtype=dt), device="cpu"),
                             tree)
        with torch.no_grad():
            logits["port", dt] = tm({"tokens": torch.from_numpy(tokens)}).float().numpy()

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    ref_drift = rel(logits["ref", "bfloat16"], logits["ref", "float32"])
    port_drift = rel(logits["port", "bfloat16"], logits["port", "float32"])
    assert ref_drift > 0.3
    assert abs(port_drift - ref_drift) <= 0.1 * ref_drift
    assert rel(logits["port", "bfloat16"], logits["ref", "bfloat16"]) <= 0.5 * ref_drift
    assert rel(logits["port", "float32"], logits["ref", "float32"]) <= 1e-3

    bcfg, fcfg = (dataclasses.replace(jcfg, dtype=d) for d in ("bfloat16", "float32"))
    tbcfg = dataclasses.replace(tcfg, dtype="bfloat16")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 64, tcfg.d_model)),
                    jnp.bfloat16)
    for i in range(tcfg.num_layers):
        layer = jax.tree.map(lambda a: a[i], jparams["layers"])
        jb = JMB.apply_mamba_block(layer, x, bcfg, phase="prefill")[0]
        jf = np.asarray(JMB.apply_mamba_block(layer, x.astype(jnp.float32), fcfg,
                                              phase="prefill")[0])
        with torch.no_grad():
            tb = TMB.apply_mamba_block(TNN.index_layer(src.tree()["layers"], i),
                                       torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
                                       tbcfg, phase="prefill")[0].float().numpy()
        jbf = np.asarray(jb, np.float32)
        ref_err = np.linalg.norm(jbf - jf)
        assert ref_err <= 0.05 * np.linalg.norm(jf - np.asarray(x, np.float32)), i
        assert abs(np.linalg.norm(tb - jf) - ref_err) <= 0.1 * ref_err, i
        assert np.linalg.norm(tb - jbf) <= 0.25 * ref_err, i
        x = jb


def test_paged_rejected_and_finetune_raises(pair):
    """The paged KV cache is refused (the family has no KV sequence), as
    the reference refuses it.  Fine-tuning, which raised before the SSD
    scan had a backward kernel, now runs: one LFA step on a fresh session
    (the pair's stays untouched for the other tests) goes through the SSD
    scan's backward (its plain version here) and moves the auxiliary cores,
    not the central ones."""
    js, ts = pair
    with pytest.raises(ValueError, match="paged KV cache requires"):
        js.serve(2, 32, paged=True)
    with pytest.raises(ValueError, match="paged KV cache requires"):
        ts.serve(2, 32, paged=True)
    fresh = TSession.init(ARCH, device="cpu")
    load_jax_params(fresh.model, _weights())
    before = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    calls = TSSD.ssd_scan_bwd_plain.calls
    rep = fresh.finetune(steps=1, seq_len=16, batch_size=2, log_every=1)
    assert TSSD.ssd_scan_bwd_plain.calls == calls + ts.cfg.num_layers
    assert len(rep["history"]) == 1 and np.isfinite(rep["history"][0]["loss"])
    after = fresh.model.state_dict()
    cores = [k for k in before if ".cores." in k]
    central = [k for k in cores if k.endswith(".central")]
    assert central and all(torch.equal(before[k], after[k]) for k in central)
    assert all(not torch.equal(before[k], after[k]) for k in cores if k not in central)
    state = ts.model.init_cache(4, 99)
    assert tuple(state.shape) == (2, 4, ts.cfg.ssm_heads, 16, 16)
    assert state.dtype == torch.float32 and not state.any()


# --------------------------------------------------------------------------
# the engine's plans for mamba's matrices
# --------------------------------------------------------------------------


def _mamba_matrix_shapes(cfg_mod, smoke):
    cfg = cfg_mod.smoke_config(ARCH) if smoke else cfg_mod.get_config(ARCH)
    params, _ = JL.split_annotations(
        jax.eval_shape(JModel.build(cfg).init, jax.random.PRNGKey(0)))
    out = {"embed": [c.shape for c in JL.cores_to_list(params["embed"]["cores"])]}
    out["embed_T"] = [(a, j, i, b) for a, i, j, b in out["embed"]]
    for name in ("in_proj", "out_proj"):
        out[name] = [c.shape[1:] for c in JL.cores_to_list(params["layers"][name]["cores"])]
    return out


@pytest.mark.parametrize("smoke", [True, False])
def test_cpu_plans_equal_reference_interpret(smoke):
    tcfg = (tconfigs.smoke_config(ARCH) if smoke else tconfigs.get_config(ARCH)).mpo
    jcfg = JL.MPOConfig(**dataclasses.asdict(tcfg))
    for name, shapes in _mamba_matrix_shapes(jconfigs, smoke).items():
        for tokens in (1, 8, 100, 4096):
            for phase in ("train", "prefill", "decode"):
                for dtype in ("float32", "bfloat16"):
                    jm, _ = JE.choose_mode(jcfg, shapes, tokens, phase, interpret=True,
                                           dtype=dtype)
                    tm, _ = TE.choose_mode(tcfg, shapes, tokens, phase, device="cpu",
                                           dtype=dtype)
                    assert tm == jm, (name, tokens, phase, dtype)


def test_full_width_plans_on_the_card():
    """What the full-width serving path runs on the card (planning is pure
    Python): the core shapes of in_proj (768 -> 3352: 3352 = 8 x 419 is no
    multiple of 16, so its out factors are (419, 2, 2, 2, 1)), out_proj
    (1536 -> 768) and the tied 50432 x 768 embedding, and each one's plan at
    8 x 512 prompt tokens, 8 decode tokens and the last-position logits."""
    cfg = tconfigs.get_config(ARCH)
    with torch.device("meta"):
        params = TMB.init(torch.Generator(), cfg)
    shapes = {"embed": [tuple(c.shape) for c in cores_to_list(params["embed"]["cores"])]}
    for name in ("in_proj", "out_proj"):
        shapes[name] = [tuple(c.shape[1:]) for c in
                        cores_to_list(params["layers"][name]["cores"])]
    assert shapes == {k: [tuple(s) for s in v] for k, v in
                      _mamba_matrix_shapes(jconfigs, False).items() if k != "embed_T"}
    assert shapes["in_proj"] == [(1, 3, 419, 64), (64, 4, 2, 64), (64, 4, 2, 32),
                                 (32, 4, 2, 4), (4, 4, 1, 1)]
    assert shapes["out_proj"] == [(1, 16, 3, 48), (48, 3, 4, 64), (64, 4, 4, 64),
                                  (64, 4, 4, 8), (8, 2, 4, 1)]
    assert shapes["embed"][0] == (1, 197, 3, 48)
    shapes["embed_T"] = [(a, j, i, b) for a, i, j, b in shapes["embed"]]

    def mode(name, tokens, phase):
        m, _ = TE.choose_mode(cfg.mpo, shapes[name], tokens, phase, device="cuda",
                              dtype="bfloat16")
        if m == "cached":         # raw cores: re-decided as a one-shot forward
            m, _ = TE.choose_mode(cfg.mpo, shapes[name], tokens, "prefill",
                                  device="cuda", dtype="bfloat16")
        return m

    # prefill, 8 x 512 tokens: both projections through the MPO-linear kernel
    assert mode("in_proj", 4096, "prefill") == "kernel"
    assert mode("out_proj", 4096, "prefill") == "kernel"
    # decode, 8 tokens: in_proj through the kernel, out_proj's chain is cheaper
    assert mode("in_proj", 8, "decode") == "kernel"
    assert mode("out_proj", 8, "decode") == "factorized"
    # the tied head (W^T) at the last position: the kernel, prefill and decode;
    # the embedding lookup is a row gather
    assert mode("embed_T", 8, "prefill") == "kernel"
    assert mode("embed_T", 8, "decode") == "kernel"
    # the weight cache densifies both projections, not the 50432 x 768 table
    eng = TE.engine_for(cfg.mpo)
    assert eng.plan(shapes["in_proj"], 1, "decode").mode == "cached"
    assert eng.plan(shapes["out_proj"], 1, "decode").mode == "cached"
    assert eng.plan(shapes["embed"], 1, "decode").mode == "factorized"

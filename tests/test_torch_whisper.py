"""The port's encdec family (``repro_torch.models.whisper``, whisper-tiny)
against the JAX package's ``repro.models.whisper``, from one weight tree
drawn by the port and carried into both through numpy
(``core.carry.load_jax_params``): smoke whisper-tiny (2 encoder and 2
decoder layers, d 64, 8 frames, ``max_pos`` 512, float32), frames drawn
with numpy.

Float32 throughout, summed in another order by two frameworks: logits,
caches and attention outputs agree to ~1e-6 relative (2e-4 allowed, as
``tests/test_torch_engine.py`` and ``tests/test_torch_zamba.py``); greedy
tokens and batches must be identical; gradients of every leaf within 2e-4
of their largest magnitude with every matmul factorized
(``tests/test_torch_train.py``'s).  The decode steps are also held to the
teacher-forced forward on the same tokens within the same 2e-4."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.core import layers as JL
from repro.core import lightweight as JLW
from repro.data import pipeline as JP
from repro.models import model as JModel
from repro.models import nn as JNN
from repro.models import whisper as JW
from repro.pipeline.scheduler import ServePool as JServePool
from repro.train import steps as JSteps
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import lightweight as TLW
from repro_torch.core.carry import load_jax_params
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TModel
from repro_torch.models import nn as TNN
from repro_torch.models import whisper as TW
from repro_torch.optim import optimizers as TOpt
from repro_torch.pipeline import cli
from repro_torch.pipeline.scheduler import ServePool
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "whisper-tiny"
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


@pytest.fixture(scope="module")
def pair():
    """(reference Session, port Session) over the same smoke weights, the
    tree checked against the reference's abstract one (nothing drawn by
    JAX)."""
    tcfg, jcfg = tconfigs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    tree = jax.tree.map(np.array, TModel.build(tcfg, seed=7, device="cpu").tree())
    abstract, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    js = JSession(jcfg, jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(tcfg, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _batch(cfg, b=3, s=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "frames": rng.normal(size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_config_archs_and_keys_match_reference(pair):
    js, ts = pair
    full_t, full_j = tconfigs.get_config(ARCH), jconfigs.get_config(ARCH)
    assert ARCH in tconfigs.ARCHS and set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(ts.cfg) == dataclasses.asdict(js.cfg)
    assert (full_t.family, full_t.num_enc_layers, full_t.num_layers, full_t.d_model,
            full_t.frontend_len, full_t.max_pos, full_t.vocab_size) == \
        ("encdec", 4, 4, 384, 1500, 32768, 51968)
    assert TModel.build(ts.cfg, device="cpu").mod is TW
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    ref = {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == ref
    assert {"embed.cores.c0", "enc_pos", "dec_pos", "encoder.attn.wq.cores.c0",
            "decoder.xattn.wk.cores.central", "decoder.ln_x.scale", "enc_norm.bias",
            "final_norm.scale"} <= set(ref)


def test_make_batch_fn_matches_reference():
    """Tokens, labels and frames bit for bit at two steps and two shards of
    a batch of 4: the frames are (B, frontend_len, d_model), drawn once from
    ``seed + 1234``, and ``seq_len`` is the decoder's tokens alone."""
    tcfg, jcfg = tconfigs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    tfn = TP.make_batch_fn(tcfg, ShapeConfig("t", "train", 12, 4), seed=5)
    jfn = JP.make_batch_fn(jcfg, JShape("t", "train", 12, 4), seed=5)
    for step in (0, 3):
        for shard in (0, 1):
            tb, jb = tfn(step, shard, 2), jfn(step, shard, 2)
            assert set(tb) == set(jb) == {"tokens", "labels", "frames"}
            for k in tb:
                np.testing.assert_array_equal(tb[k], jb[k], k)
            assert tb["frames"].shape == (2, tcfg.frontend_len, tcfg.d_model)
            assert tb["tokens"].shape == tb["labels"].shape == (2, 12)


@pytest.mark.parametrize("rope_qk", [False, True])
def test_cross_attention_matches_reference(pair, rope_qk):
    """``apply_attention(kv_x=...)``: K and V from ``kv_x`` (another length
    than x), no rope on K; with a cache, the cache's K/V are attended and
    the cache comes back unchanged.  ``rope_qk`` adds rope and qk-norm,
    which whisper does not use, to show that K takes no rope."""
    js, ts = pair
    cfg = ts.cfg
    acfg = TNN.AttnCfg(d_model=cfg.d_model, num_heads=cfg.num_heads,
                       num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                       use_rope=rope_qk, qk_norm=rope_qk, causal=False)
    jacfg = JNN.AttnCfg(**dataclasses.asdict(acfg))
    gen = torch.Generator().manual_seed(3)
    params = TNN.init_attention(gen, acfg, cfg.mpo)
    if rope_qk:
        for k in ("q_norm", "k_norm"):
            params[k]["scale"] = 1 + 0.1 * torch.randn(cfg.head_dim, generator=gen)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    kv_x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = (3 + np.arange(5))[None, :]
    mask = np.ones((1, 1, 5, 9), bool)
    jy, jc = JNN.apply_attention(jparams, jnp.asarray(x), jacfg, js.cfg.mpo,
                                 positions=jnp.asarray(pos), mask=jnp.asarray(mask),
                                 kv_x=jnp.asarray(kv_x))
    with torch.no_grad():
        ty, tc = TNN.apply_attention(params, torch.from_numpy(x), acfg, cfg.mpo,
                                     positions=torch.from_numpy(pos),
                                     mask=torch.from_numpy(mask), kv_x=torch.from_numpy(kv_x))
    assert jc is None and tc is None
    _close(ty.numpy(), jy)
    # with a cache of precomputed K/V (of 9 positions)
    ck = rng.standard_normal((2, 9, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    cv = rng.standard_normal((2, 9, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
              "pos": torch.tensor(9, dtype=torch.int32)}
    jy, jc = JNN.apply_attention(jparams, jnp.asarray(x), jacfg, js.cfg.mpo,
                                 positions=jnp.asarray(pos), mask=jnp.asarray(mask),
                                 kv_x=jnp.asarray(kv_x),
                                 cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                                        "pos": jnp.int32(9)})
    with torch.no_grad():
        ty, out = TNN.apply_attention(params, torch.from_numpy(x), acfg, cfg.mpo,
                                      positions=torch.from_numpy(pos),
                                      mask=torch.from_numpy(mask),
                                      kv_x=torch.from_numpy(kv_x), cache=tcache)
    assert out is tcache and int(tcache["pos"]) == int(jc["pos"]) == 9
    np.testing.assert_array_equal(tcache["k"].numpy(), ck)
    np.testing.assert_array_equal(tcache["v"].numpy(), cv)
    _close(ty.numpy(), jy)


def test_forward_matches_reference(pair):
    js, ts = pair
    batch = _batch(js.cfg, 2, 16)
    jl, aux = js.model.forward(js.params, _jb(batch))
    with torch.no_grad():
        tl = ts.model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux) == 0.0 and tuple(tl.shape) == (2, 16, js.cfg.vocab_size)
    _close(tl.numpy(), jl)


def test_prefill_and_decode_match_reference_and_teacher_forced(pair):
    """Prefill, then 3 decode steps: logits, every layer's K/V and position
    and the stored encoder output against the reference's; each decode
    step's logits against the teacher-forced forward over the same tokens."""
    js, ts = pair
    batch = _batch(js.cfg, 3, 12, seed=1)
    jh = js.serve(3, 24, weight_cache=False)
    th = ts.serve(3, 24, weight_cache=False)
    jl = np.asarray(jh.prefill(_jb(batch)))
    tl = th.prefill(batch)
    assert tuple(tl.shape) == (3, 1, js.cfg.vocab_size)
    _close(tl.numpy(), jl)

    def same_cache():
        assert set(th.cache) == {"self", "enc_out"}
        assert set(th.cache["self"]) == {"k", "v", "pos"}
        assert th.cache["self"]["pos"].shape == (ts.cfg.num_layers,)
        assert th.cache["self"]["pos"].dtype == torch.int32
        np.testing.assert_array_equal(th.cache["self"]["pos"].numpy(),
                                      np.asarray(jh.cache["self"]["pos"]))
        for k in ("k", "v"):
            _close(th.cache["self"][k].numpy(), jh.cache["self"][k])
        _close(th.cache["enc_out"].numpy(), jh.cache["enc_out"])

    same_cache()
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    toks, steps = [tok], [tl[:, -1].numpy()]
    for _ in range(3):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        _close(tl.numpy(), jl)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        steps.append(tl[:, -1].numpy())
        tok = np.asarray(jt)
        toks.append(tok)
    same_cache()
    assert int(th.cache["self"]["pos"][0]) == 12 + 3
    seq = np.concatenate([batch["tokens"]] + toks[:-1], axis=1)
    with torch.no_grad():
        tf = ts.model({"tokens": torch.from_numpy(seq),
                       "frames": torch.from_numpy(batch["frames"])})[:, 11:].numpy()
    _close(np.stack(steps, 1), tf)


def test_decode_clamps_the_position_row_as_the_reference(pair):
    """A decode step at a position past ``max_pos`` (and past the cache's
    ``max_len``): the reference's ``dynamic_slice_in_dim`` clamps the
    ``dec_pos`` row to the last and ``dynamic_update_slice`` the K/V write
    to the cache's last row; the port clamps both on the device."""
    js, ts = pair
    cfg = ts.cfg
    batch = _batch(cfg, 2, 6, seed=2)
    jcache = js.model.init_cache(2, 10)
    _, jcache = jax.jit(lambda p, b, c: JW.prefill(p, b, c, js.cfg))(js.params, _jb(batch),
                                                                     jcache)
    tcache = ts.model.init_cache(2, 10)
    with torch.no_grad():
        ts.model.prefill(ts.params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
    at = cfg.max_pos + 40
    jcache = {"self": dict(jcache["self"], pos=jnp.full((cfg.num_layers,), at, jnp.int32)),
              "enc_out": jcache["enc_out"]}
    tcache["self"]["pos"].fill_(at)
    tok = np.array([[5], [7]], np.int32)
    jl, jcache = jax.jit(lambda p, t, c: JW.decode_step(p, t, c, js.cfg))(
        js.params, jnp.asarray(tok), jcache)
    with torch.no_grad():
        tl, tcache = ts.model.decode_step(ts.params, torch.from_numpy(tok), tcache)
    _close(tl.numpy(), jl)
    for k in ("k", "v"):
        _close(tcache["self"][k].numpy(), jcache["self"][k])
    assert (tcache["self"]["pos"].numpy() == at + 1).all()


def test_reset_cache_rewinds_in_place(pair):
    _, ts = pair
    h = ts.serve(2, 24)
    c = h.cache
    tensors = [c["self"]["k"], c["self"]["v"], c["self"]["pos"], c["enc_out"]]
    batch = _batch(ts.cfg, 2, 8, seed=4)
    first = h.generate(batch, 3)
    assert int(c["self"]["pos"][0]) == 10 and c["enc_out"].abs().sum() > 0
    h.reset()
    c = h.cache
    got = [c["self"]["k"], c["self"]["v"], c["self"]["pos"], c["enc_out"]]
    assert all(a is b and not a.any() for a, b in zip(tensors, got))
    torch.testing.assert_close(h.generate(batch, 3), first, rtol=0, atol=0)


@pytest.mark.parametrize("weight_cache", [True, False])
def test_greedy_generation_identical(pair, weight_cache):
    js, ts = pair
    batch = _batch(js.cfg, 3, 10, seed=5)
    jo = js.serve(3, 24, weight_cache=weight_cache).generate(_jb(batch), 8)
    to = ts.serve(3, 24, weight_cache=weight_cache).generate(batch, 8)
    assert to.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_train_step_grads_and_lfa_losses_match_reference(pair):
    """One train step's gradients of every leaf (factorized matmuls) against
    ``jax.grad`` of the reference's loss (remat off, then on: the same
    bits), then 2 LFA steps' losses against the reference's ``finetune``
    from the same tree."""
    js, ts = pair
    mpo = dict(mode="factorized")
    jcfg = dataclasses.replace(js.cfg, mpo=dataclasses.replace(js.cfg.mpo, **mpo))
    jm = JModel.build(jcfg)
    batch = ts._default_batch_fn(12, 4, 0)(0)
    assert set(batch) == {"tokens", "labels", "frames"}
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
        _, tmet = step(TSteps.TrainState(model.tree(), opt.init(model.tree())),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
        grads[remat] = _flat(seen[0])
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=TOL)
    assert set(grads[False]) == set(jg)
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        np.testing.assert_allclose(grads[False][k], jg[k], atol=TOL * scale, rtol=TOL,
                                   err_msg=k)
        np.testing.assert_array_equal(grads[True][k], grads[False][k], err_msg=k)
    for k in ("enc_pos", "dec_pos", "encoder.attn.wq.cores.c0", "decoder.xattn.wk.cores.c0"):
        assert np.abs(jg[k]).max() > 0, k
    # 2 LFA steps from clones of the same tree
    jsess = JSession(js.cfg, js.params)
    tsess = TSession.init(ts.cfg, device="cpu")
    tsess.model.set_tree(ts.params)
    ft = dict(mode="lfa", steps=2, lr=2e-3, seq_len=12, batch_size=4, log_every=1)
    jr, tr = jsess.finetune(**ft), tsess.finetune(**ft)
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"])
    for jh, th in zip(jr["history"], tr["history"], strict=True):
        assert th["loss"] == pytest.approx(jh["loss"], rel=TOL)


def test_full_width_lfa_count_matches_reference():
    """The LFA split of full-width whisper-tiny from abstract trees (nothing
    drawn): 14,592,960 of 18,860,992 parameters train, ``enc_pos`` and
    ``dec_pos`` (32768 x 384) among them."""
    jp, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config(ARCH)).init, jax.random.PRNGKey(0)))
    with torch.device("meta"):
        tp = TW.init(torch.Generator(), tconfigs.get_config(ARCH))
    tc = TLW.count_trainable(tp, TLW.trainable_mask(tp, mode="lfa"))
    assert tc == JLW.count_trainable(jp, JLW.trainable_mask(jp, mode="lfa"))
    assert tc == (14_592_960, 18_860_992)
    assert tuple(tp["dec_pos"].shape) == (32768, 384)
    assert tuple(tp["enc_pos"].shape) == (1500, 384)
    rows = np.prod([c.shape[-3] for c in TLW.leaves(tp["embed"]["cores"])])
    assert rows == 51968


def test_paged_cache_and_pool_are_refused(pair):
    js, ts = pair
    with pytest.raises(ValueError, match="not supported for family 'encdec'"):
        js.model.init_cache(2, 16, paged=True)
    with pytest.raises(ValueError, match="not supported for family 'encdec'"):
        ts.model.init_cache(2, 16, paged=True)
    with pytest.raises(ValueError, match="not supported for family 'encdec'"):
        ts.serve(2, 16, paged=True)
    assert ts.model.prefill_chunk is None and js.model.prefill_chunk is None
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        JServePool(js.model, js.params, 2, 16)
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        ServePool(ts.model, ts.params, 2, 16)
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        ts.serve_pool(2, 16)
    with pytest.raises(NotImplementedError, match="ServePool supports families"):
        ts.serve_fleet(2, 2, 16)


@pytest.mark.parametrize("arch,extra", [("whisper-tiny", "frames"),
                                        ("llava-next-34b", "patches")])
def test_cli_serves_frontend_inputs(capsys, arch, extra):
    """The lifecycle command's serving sample carries the frontend input
    the reference's ``make_batch`` gives a prefill (its shapes, numpy
    draws), and the command serves smoke whisper-tiny and llava-next-34b on
    the CPU."""
    tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
    got = cli.sample_batch(tcfg, 2, 12)
    want = JModel.make_batch(jcfg, JShape("cli", "prefill", 12, 2))
    assert set(got) == set(want) == {"tokens", extra}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert cli.main(["--arch", arch, "--steps", "1", "--batch", "2", "--prompt-len", "12",
                     "--tokens", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ids = [ln for ln in lines if "sample ids" in ln]
    assert len(ids) == 1 and len(json.loads(ids[0].split(": ", 1)[1])) == 3
    report = json.loads("\n".join(lines[lines.index("{"):]))
    assert report["arch"] == arch
    assert [s["stage"] for s in report["stages"]] == ["init", "finetune", "serve"]

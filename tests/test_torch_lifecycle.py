"""The paper's lifecycle in the port — ``Session.from_dense`` (Algorithm 1)
-> ``squeeze`` (Algorithm 2) -> ``serve`` — held against the JAX package's
``Session`` on smoke bert-base (cls) and smoke qwen3-14b (lm), from the
reference's own dense tree carried through numpy (the roundtrip of
``tests/test_pipeline.py``; the reference's init and Algorithm 1 jitted, once
for each arch), squeezing without a re-tune and, on bert-base,
with the LFA re-tune of every iteration; the re-tune alone on one tree;
``Model.set_tree`` and the entry points that wait for later items.

Tolerances (float32, two frameworks' LAPACK calls):
- conversion errors within 1e-5 relative; converted logits within 1e-4 of
  their largest magnitude (observed 7e-5 at qwen3-14b, 1e-4 allowed).
- squeeze: the same (layer, bond, new_dim) sequence, each step's winner
  first shown to lead its runner-up by more than 1e-3 relative (never a
  pass on a near-tie); predicted errors within 1e-4 relative (1.4e-5
  observed); metrics within 1e-4.
- reconstructions of every matrix within 5e-4 of their largest magnitude:
  the conversion truncates full-rank Gaussian matrices between singular
  values ~1% apart, where float32 rounding turns the kept subspace, and
  squeeze moves compound it: each framework's float32 result lies up to
  9.4e-5 from a float64 run of the same pipeline, the two up to 1.1e-4
  apart (measured).
- with the re-tune (``finetune_steps=2``), reconstructions within 5e-3 of
  their largest magnitude: AdamW's first steps move each trainable element
  by about lr x sign(g), and an element whose gradient is within float32
  noise of zero takes either sign in the two frameworks (one element in
  ~500 of a leaf, measured), 1.8e-3 apart after three iterations
  (measured); a batch offset or lr off by one step or 2x lands 6e-2 apart.
- the re-tune alone, on one tree carried into both: each trainable leaf's
  update within 5e-2 of the update's norm (1.8e-2 observed, the same
  isolated sign flips; a wrong batch offset or lr gives > 1), frozen
  leaves bit-unchanged.
- serving after the squeeze: prefill logits within 5e-4 of their largest
  magnitude (2e-4 observed), greedy tokens identical.
- albert-base (one stored layer, ``share_layers``) with the re-tune: a sign
  flip of the re-tune (above) lands in the one layer every position of the
  stack applies, so the served logits inherit the reconstructions' gap
  whole (1.7e-3 of W, 1.4e-3 of the logits measured, where bert-base's
  independent layers give 4.9e-4): prefill logits, and every decode step's
  logits fed the reference's greedy tokens, within ``REC_TUNED_TOL`` of
  their largest magnitude, and the greedy tokens identical up to the first
  step whose reference top-2 margin is within twice that gap."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import convert as JC
from repro.core import layers as JL
from repro.core import squeeze as JSQ
from repro.core.engine import _reconstruct_stacked
from repro.core.layers import cores_to_list as j_cores_to_list
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import jax_tree_to_torch, load_jax_params
from repro_torch.core.layers import cores_to_list
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import model as TModel
from repro_torch.resilience.journal import SqueezeJournal

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

# (arch, LFA re-tune steps a squeeze iteration)
CASES = (("bert-base", 0), ("qwen3-14b", 0), ("bert-base", 2), ("albert-base", 0),
         ("albert-base", 2))
SEQ, BATCH, ITERS = 16, 4, 3
CONV_TOL, LOGIT_TOL, EPS_TOL, GAP = 1e-5, 1e-4, 1e-4, 1e-3
REC_TOL, SERVE_TOL = 5e-4, 5e-4
REC_TUNED_TOL, UPDATE_TOL = 5e-3, 5e-2


def _dense_cfg(cfg):
    return dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))


@functools.lru_cache(maxsize=None)
def _reference_conversion(arch):
    """The reference's smoke dense tree (``PRNGKey(0)``), its Algorithm 1
    conversion and per-matrix error report (``Session.from_dense``'s three
    steps), the first two jitted, made once a module for each arch: the
    eager init and conversion cost ~14 s a call on a CPU."""
    jcfg = jconfigs.smoke_config(arch)
    model = JModel.build(_dense_cfg(jcfg))
    dense = jax.jit(lambda k: JL.split_annotations(model.init(k))[0])(jax.random.PRNGKey(0))
    template, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    conv = jax.jit(lambda d: JC.convert_dense_to_mpo(d, template))(dense)
    return dense, conv, JC.conversion_error(dense, conv)


def _reference_from_dense(arch):
    """(a reference session at the ``from_dense`` stage of its own, the dense
    tree) from ``_reference_conversion``."""
    dense, conv, report = _reference_conversion(arch)
    js = JSession(jconfigs.smoke_config(arch), conv)
    js.stage, js.conversion_report = "from_dense", dict(report)
    return js, dense


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_clear_winners(params, iters):
    """Replays ``iters`` squeeze moves on ``params`` (no re-tune, as the
    lifecycle runs them) and fails unless each winner leads its runner-up by
    more than GAP relative."""
    for it in range(iters):
        cands = sorted(TSQ.candidates(TSQ.find_mpo_layers(params)), key=lambda c: c[-1])
        gap = (cands[1][-1] - cands[0][-1]) / cands[0][-1]
        assert gap > GAP, f"iteration {it}: near-tie {cands[0][:2]} vs {cands[1][:2]} ({gap})"
        params, _ = TSQ.squeeze_once(params)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-retune{c[1]}")
def lifecycle(request):
    """Both sessions converted from the reference's dense tree, squeezed
    (with ``finetune_steps`` re-tune steps an iteration) and served; a
    pre-squeeze handle kept."""
    arch, steps = request.param
    tcfg = tconfigs.smoke_config(arch)
    js, dense = _reference_from_dense(arch)
    dense_np = jax.tree.map(np.asarray, dense)
    ts = TSession.from_dense(dense_np, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 7)).astype(np.int32)
    converted = {"port": ts.model({"tokens": torch.from_numpy(prompts)}).numpy(),
                 "ref": np.asarray(js.model.forward(js.params, {"tokens": jnp.asarray(prompts)})[0],
                                   np.float32)}
    pre = ts.serve(3, 16)
    # the trees each iteration chooses from: the converted one, then each
    # re-tune's result (recorded on this session only)
    chosen_from = [jax.tree.map(lambda t: t.detach().clone(), ts.params)]
    tune = ts._tune_params
    ts._tune_params = lambda p, **k: chosen_from.append(tune(p, **k)) or chosen_from[-1]
    kw = dict(delta=100.0, max_iters=ITERS, finetune_steps=steps, seq_len=SEQ, batch_size=BATCH)
    rho_before = TSQ.model_compression_ratio(ts.params)
    jev, tev = js.squeeze(**kw), ts.squeeze(**kw)
    del ts._tune_params
    if steps:
        assert len(chosen_from) == ITERS + 1
        for tree in chosen_from[:-1]:
            _assert_clear_winners(tree, 1)
    else:
        _assert_clear_winners(chosen_from[0], ITERS)
    return dict(js=js, ts=ts, dense_np=dense_np, prompts=prompts, converted=converted,
                pre=pre, jev=jev, tev=tev, rho_before=rho_before,
                rec_tol=REC_TUNED_TOL if steps else REC_TOL,
                shared_tuned=bool(steps and tcfg.share_layers))


def test_from_dense_conversion_errors_and_logits_match_reference(lifecycle):
    js, ts = lifecycle["js"], lifecycle["ts"]
    rep = ts.report()
    assert rep["stages"][0]["stage"] == "from_dense"
    assert rep["stages"][0]["matrices"] == len(js.conversion_report) > 0
    assert set(ts.conversion_report) == set(js.conversion_report)
    for k, v in js.conversion_report.items():
        assert ts.conversion_report[k] == pytest.approx(v, rel=CONV_TOL), k
    errs = list(ts.conversion_report.values())
    assert rep["conversion_max_rel_err"] == max(errs)
    assert rep["conversion_mean_rel_err"] == pytest.approx(np.mean(errs))
    assert rep["stages"][0]["max_rel_err"] == max(errs)
    assert _max_rel(lifecycle["converted"]["port"], lifecycle["converted"]["ref"]) <= LOGIT_TOL


def test_squeeze_events_and_rho_match_reference(lifecycle):
    jev, tev = lifecycle["jev"], lifecycle["tev"]
    assert len(tev) == len(jev) == ITERS
    for j, t in zip(jev, tev):
        assert (t.step, t.layer, t.bond, t.new_dim) == (j.step, j.layer, j.bond, j.new_dim)
        assert t.predicted_error == pytest.approx(j.predicted_error, rel=EPS_TOL)
        assert t.metric == pytest.approx(j.metric, rel=EPS_TOL, abs=EPS_TOL)
        assert set(t.seconds) == {"spectra", "tt_round", "retune", "eval"}
    ts = lifecycle["ts"]
    rep = ts.report()
    stage = rep["stages"][-1]
    assert stage["stage"] == "squeeze" and stage["events"] == ITERS
    assert stage["rho_before"] == lifecycle["rho_before"]
    assert stage["rho_after"] == rep["compression_ratio"] < stage["rho_before"]
    assert rep["squeeze_events"] == ITERS and ts.squeeze_history == tev
    # rho by an independent count: core parameters over L * I * J a matrix
    num = den = 0
    for cd in TSQ.find_mpo_layers(ts.params).values():
        cs = cores_to_list(cd)
        stack = int(np.prod(cs[0].shape[:-4]))
        num += sum(c.numel() for c in cs)
        den += stack * int(np.prod([c.shape[-3] for c in cs])) * int(
            np.prod([c.shape[-2] for c in cs]))
    assert rep["compression_ratio"] == pytest.approx(num / den, rel=1e-12)


def test_squeezed_reconstructions_match_reference(lifecycle):
    js, ts = lifecycle["js"], lifecycle["ts"]
    jl, tl = JSQ.find_mpo_layers(js.params), TSQ.find_mpo_layers(ts.params)
    assert set(tl) == set(jl)
    for path in tl:
        tcores = cores_to_list(tl[path])
        jcores = j_cores_to_list(jl[path])
        assert [tuple(c.shape) for c in tcores] == [tuple(c.shape) for c in jcores], path
        rt = TM.reconstruct_stacked(tcores).numpy()
        rj = np.asarray(_reconstruct_stacked(jcores))
        assert _max_rel(rt, rj) <= lifecycle["rec_tol"], path


def test_serve_after_squeeze_redensifies_and_matches_reference(lifecycle):
    """The pre-squeeze handle is stale: ``serve`` builds a new one from the
    squeezed cores (its cached W equal to their reconstruction), whose
    prefill logits and greedy tokens match the reference's squeezed
    session's."""
    js, ts, prompts = lifecycle["js"], lifecycle["ts"], lifecycle["prompts"]
    pre = lifecycle["pre"]
    h = ts.serve(3, 16)
    assert h is not pre and h.version == ts.weights_version > pre.version
    for path, _ in TSQ.find_mpo_layers(ts.params).items():
        node = h.params
        for k in path[:-1]:
            node = node[k]
        if "w" in node:      # densified for decode: the squeezed cores' W
            want = TM.reconstruct_stacked(cores_to_list(TSQ.find_mpo_layers(ts.params)[path]))
            assert torch.equal(node["w"], want), path
    got = h.prefill({"tokens": prompts}).numpy()
    want = np.asarray(js.serve(3, 16).prefill({"tokens": jnp.asarray(prompts)}), np.float32)
    tt = h.generate({"tokens": prompts}, 6).numpy()
    jt = np.asarray(js.serve(3, 16).generate({"tokens": jnp.asarray(prompts)}, 6))
    if not lifecycle["shared_tuned"]:
        assert _max_rel(got, want) <= SERVE_TOL
        np.testing.assert_array_equal(tt, jt)
        return
    # one shared re-tuned layer (module docstring): logits within the
    # reconstructions' gap, teacher-forced on the reference's tokens
    assert _max_rel(got, want) <= REC_TUNED_TOL
    jh, th = js.serve(3, 16), h.reset()
    steps = [(th.prefill({"tokens": prompts}).numpy()[:, -1],
              np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}), np.float32)[:, -1])]
    for k in range(jt.shape[1] - 1):
        tok = jt[:, k:k + 1]
        steps.append((th.decode(tok)[1].numpy()[:, -1],
                      np.asarray(jh.decode(jnp.asarray(tok))[1], np.float32)[:, -1]))
    for k, (a, b) in enumerate(steps):
        assert _max_rel(a, b) <= REC_TUNED_TOL, k
    ref = np.stack([b for _, b in steps], 1)                      # (slot, step, V)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * REC_TUNED_TOL * np.abs(ref).max()
    for row in range(jt.shape[0]):
        n = int(np.argmin(clear[row])) if not clear[row].all() else jt.shape[1]
        np.testing.assert_array_equal(tt[row, :n], jt[row, :n])


def test_ssm_lifecycle_matches_reference_on_carried_weights():
    """mamba2-130m through the paper's workflow on both sides: ``from_dense``
    of the reference's dense tree (conversion errors and reconstructions as
    above), then the reference's converted tree carried into the port; 2 LFA
    steps (losses and cores within ``tests/test_torch_train.py``'s
    tolerances; every SSD scan of the port's steps runs its backward's
    plain version), two squeeze iterations (the same events, each winner
    clear of its runner-up, rho falling), then served: prefill logits within
    ``SERVE_TOL``, greedy tokens identical.

    The LFA trajectories are compared from one tree, and the squeeze runs
    without a re-tune: the two frameworks' SVDs (in ``from_dense`` and in
    each iteration's ``tt_round``) give the cores other gauges, and AdamW's
    per-element steps are not gauge-invariant, so a re-tune after either
    moves the two models' served logits apart by more than ``SERVE_TOL``;
    ``test_squeeze_refusals_name_their_items`` runs the ssm re-tune."""
    arch, steps, lr = "mamba2-130m", 2, 2e-3
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    dense, _ = JModel.build(_dense_cfg(jcfg)).init_params(jax.random.PRNGKey(0))
    js = JSession.from_dense(dense, jcfg)
    ts = TSession.from_dense(jax.tree.map(np.asarray, dense), tcfg, device="cpu")
    assert set(ts.conversion_report) == set(js.conversion_report)
    for k, v in js.conversion_report.items():
        assert ts.conversion_report[k] == pytest.approx(v, rel=CONV_TOL), k
    for path, cd in TSQ.find_mpo_layers(ts.params).items():
        rt = TM.reconstruct_stacked(cores_to_list(cd)).numpy()
        rj = np.asarray(_reconstruct_stacked(j_cores_to_list(JSQ.find_mpo_layers(js.params)[path])))
        assert _max_rel(rt, rj) <= REC_TOL, path
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.params))
    calls = TSSD.ssd_scan_bwd_plain.calls
    kw = dict(mode="lfa", steps=steps, lr=lr, seq_len=SEQ, batch_size=BATCH, log_every=1)
    jr, tr = js.finetune(**kw), ts.finetune(**kw)
    assert TSSD.ssd_scan_bwd_plain.calls == calls + steps * tcfg.num_layers
    for jh, th in zip(jr["history"], tr["history"]):
        assert th["loss"] == pytest.approx(jh["loss"], rel=2e-4)
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"])
    jf = jax.tree.map(np.asarray, js.params)
    for path, cd in TSQ.find_mpo_layers(ts.params).items():
        for name, core in cd.items():
            want = JSQ.find_mpo_layers(jf)[path][name]
            assert np.abs(core.detach().numpy() - want).max() <= lr * steps, (path, name)
    _assert_clear_winners(ts.params, 2)
    sq = dict(delta=100.0, max_iters=2, finetune_steps=0, seq_len=SEQ, batch_size=BATCH)
    rho = TSQ.model_compression_ratio(ts.params)
    jev, tev = js.squeeze(**sq), ts.squeeze(**sq)
    assert len(tev) == len(jev) == 2
    for j, t in zip(jev, tev):
        assert (t.step, t.layer, t.bond, t.new_dim) == (j.step, j.layer, j.bond, j.new_dim)
        assert t.predicted_error == pytest.approx(j.predicted_error, rel=EPS_TOL)
        assert t.metric == pytest.approx(j.metric, rel=EPS_TOL, abs=EPS_TOL)
    assert ts.report()["compression_ratio"] < rho
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 7)).astype(np.int32)
    h, jh = ts.serve(3, 16), js.serve(3, 16)
    got = h.prefill({"tokens": prompts}).numpy()
    want = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}), np.float32)
    assert _max_rel(got, want) <= SERVE_TOL
    np.testing.assert_array_equal(h.reset().generate({"tokens": prompts}, 6).numpy(),
                                  np.asarray(js.serve(3, 16).generate(
                                      {"tokens": jnp.asarray(prompts)}, 6)))


def test_set_tree_carries_a_squeezed_reference_tree(lifecycle):
    """A tree the reference squeezed enters a fresh port model through
    ``set_tree`` (bonds changed), and its forward matches the reference's;
    a strict load of the same tree refuses the new bonds."""
    js, ts, prompts = lifecycle["js"], lifecycle["ts"], lifecycle["prompts"]
    tree = jax.tree.map(np.asarray, js.params)
    model = TModel.build(ts.cfg, device="cpu").set_tree(jax_tree_to_torch(tree))
    got = model({"tokens": torch.from_numpy(prompts)}).numpy()
    want = np.asarray(js.model.forward(js.params, {"tokens": jnp.asarray(prompts)})[0], np.float32)
    assert _max_rel(got, want) <= LOGIT_TOL
    from repro_torch.core.carry import load_jax_params
    with pytest.raises(ValueError, match="cores"):
        load_jax_params(TModel.build(ts.cfg, device="cpu"), tree)


def test_retune_matches_reference_on_one_tree():
    """``Session._tune_params`` (the re-tune inside every squeeze iteration:
    a clone, the LFA mask, AdamW without weight decay, batches from 2000 on)
    against the reference's on the reference's converted tree carried into
    the port: each trainable leaf moves as the reference's does within
    UPDATE_TOL of its update's norm; frozen leaves and the given tree keep
    their bits."""
    tcfg = tconfigs.smoke_config("bert-base")
    js, _ = _reference_from_dense("bert-base")
    ts = TSession.init(tcfg, device="cpu")
    ts.model.set_tree(jax_tree_to_torch(jax.tree.map(np.asarray, js.params)))
    given = jax.tree.map(lambda t: t.detach().clone(), ts.params)
    kw = dict(steps=2, lr=1e-3, mode="lfa")
    jout = js._tune_params(js.params, loss_fn=js._default_loss_fn(),
                           batch_fn=js._default_batch_fn(SEQ, BATCH, 0), **kw)
    tout = ts._tune_params(ts.params, loss_fn=ts._default_loss_fn(),
                           batch_fn=ts._default_batch_fn(SEQ, BATCH, 0), **kw)
    flat = lambda t: {jax.tree_util.keystr(k): v for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    jf, tf, before, now = flat(jout), flat(tout), flat(js.params), flat(ts.params)
    assert set(tf) == set(jf) == set(before)
    frozen = 0
    for k, t in tf.items():
        t, start = t.detach().numpy().astype(np.float64), np.asarray(before[k], np.float64)
        assert torch.equal(now[k], flat(given)[k]), k
        update = np.asarray(jf[k], np.float64) - start
        if not update.any():
            frozen += 1
            np.testing.assert_array_equal(t, start, err_msg=k)
            continue
        assert np.linalg.norm(t - start - update) <= UPDATE_TOL * np.linalg.norm(update), k
    assert frozen == len(TSQ.find_mpo_layers(ts.params))   # the central cores


def test_set_tree_refuses_what_is_not_a_bond_change():
    model = TModel.build(tconfigs.smoke_config("bert-base"), device="cpu")
    tree = {k: v for k, v in model.tree().items()}

    def with_leaf(path, value):
        out = jax.tree.map(lambda t: t, tree)
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
        return out

    scale = tree["final_norm"]["scale"]
    c0 = tree["embed"]["cores"]["c0"]
    c1 = tree["embed"]["cores"]["c1"]
    for path, value, match in (
            (("final_norm", "scale"), torch.ones(scale.shape[0] + 1), "final_norm.scale"),
            (("final_norm", "scale"), scale.double(), "final_norm.scale"),
            (("embed", "cores", "c0"), c0[:, :1], "embed.cores.c0"),      # an i leg
            (("embed", "cores", "c0"), c0.half(), "embed.cores.c0")):
        with pytest.raises(ValueError, match=match):
            model.set_tree(with_leaf(path, value))
    with pytest.raises(KeyError, match="missing"):
        model.set_tree({k: v for k, v in tree.items() if k != "final_norm"})
    # a bond change is taken: the parameters change shape, the rest is copied
    before = model.final_norm.scale
    new = with_leaf(("embed", "cores", "c0"), c0[..., :-1].clone())
    new = dict(new, embed={"cores": dict(new["embed"]["cores"], c1=c1[:-1].clone())})
    model.set_tree(new)
    assert model.embed.cores.c0.shape[-1] == c0.shape[-1] - 1
    assert model.embed.cores.c1.shape[0] == c1.shape[0] - 1
    assert model.final_norm.scale is before and not model.embed.cores.c0.requires_grad


def test_from_dense_full_rank_is_exact_and_takes_tensors():
    """At full rank the conversion reproduces the dense model (Eq. 1), from
    the port's own dense build given as tensors."""
    cfg = tconfigs.smoke_config("qwen3-14b")
    full = dataclasses.replace(cfg, mpo=dataclasses.replace(
        cfg.mpo, bond_embed=None, bond_attn=None, bond_ffn=None))
    dense = TModel.build(_dense_cfg(cfg), seed=3, device="cpu")
    s = TSession.from_dense(dense.tree(), full, device="cpu")
    assert s.report()["conversion_max_rel_err"] < 1e-4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)))
    assert _max_rel(s.model({"tokens": tokens}).numpy(), dense({"tokens": tokens}).numpy()) < 1e-4
    assert TSession.from_dense(dense.tree(), full, device="cpu", report=False) \
        .conversion_report == {}


def test_rejected_iteration_leaves_the_accepted_tree_untouched():
    """A re-tune trains a copy: with every iteration rejected (delta < 0)
    the session's parameters keep their bits and shapes; the weights
    version still moves (the squeeze installed its result)."""
    ts = TSession.init("bert-base", device="cpu")
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    ev = ts.squeeze(delta=-1.0, max_iters=2, finetune_steps=2, seq_len=SEQ, batch_size=BATCH)
    assert len(ev) == 1 and ts.weights_version == 1
    after = ts.model.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())


def test_squeeze_refusals_name_their_items(tmp_path):
    """The ssm family's squeeze, refused until the SSD scan had a backward
    kernel, now runs: one iteration with a one-step LFA re-tune (the SSD
    backward's plain version here) truncates a bond, and with ``ckpt_dir``
    journals the accepted iteration there."""
    ms = TSession.init("mamba2-130m", device="cpu")
    jdir = tmp_path / "journal"
    calls, rho = TSSD.ssd_scan_bwd_plain.calls, TSQ.model_compression_ratio(ms.params)
    ev = ms.squeeze(delta=100.0, max_iters=1, finetune_steps=1, seq_len=SEQ, batch_size=BATCH,
                    ckpt_dir=str(jdir))
    assert len(ev) == 1 and TSQ.model_compression_ratio(ms.params) < rho
    assert TSSD.ssd_scan_bwd_plain.calls == calls + ms.cfg.num_layers
    assert jdir.is_dir() and any(jdir.iterdir())
    _, nxt, hist, _ = SqueezeJournal(str(jdir)).load(ms.params)
    assert nxt == 1 and hist == ev

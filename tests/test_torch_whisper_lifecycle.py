"""The encdec family (smoke whisper-tiny: 2 encoder and 2 decoder layers,
8 frames) through the paper's lifecycle in the port and the JAX package,
from one dense tree drawn by the port and carried through numpy:
``Session.from_dense`` (Algorithm 1) -> ``finetune`` (LFA, 2 steps) ->
``squeeze`` (Algorithm 2, one iteration) -> ``serve`` -> ``save`` /
``restore`` across the packages.

The fine-tuning is compared from one tree: the reference's converted tree
is carried into the port first, since the two frameworks' SVDs give the
cores other gauges and AdamW's per-element steps are not gauge-invariant
(``tests/test_torch_lifecycle.py``).  Tolerances are
``tests/test_torch_zamba_lifecycle.py``'s, for the same reasons (float32,
two frameworks' LAPACK calls):
- conversion errors within 1e-5 relative; converted reconstructions and
  logits within 5e-4 of their largest magnitude (truncated full-rank
  Gaussian matrices);
- fine-tuning losses within 2e-4 relative; every core within lr x steps of
  the reference's;
- the squeeze: the same (layer, bond, new_dim), its winner first shown to
  lead its runner-up by more than 1e-3 relative; predicted errors and
  metrics within 1e-4 relative;
- serving: prefill logits within 5e-4 of their largest magnitude, greedy
  tokens identical."""

import dataclasses

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
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import load_jax_params
from repro_torch.core.layers import cores_to_list
from repro_torch.core.lightweight import leaves
from repro_torch.models import model as TModel

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "whisper-tiny"
SEQ, BATCH, LR, STEPS = 12, 4, 2e-3, 2
CONV_TOL, REC_TOL, EPS_TOL, GAP, LOSS_TOL, SERVE_TOL = 1e-5, 5e-4, 1e-4, 1e-3, 2e-4, 5e-4


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _event(e) -> tuple:
    return (e.step, tuple(e.layer), e.bond, e.new_dim)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    tcfg, jcfg = tconfigs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    dense_cfg = dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, enabled=False))
    dense = jax.tree.map(lambda t: t.detach().numpy(),
                         TModel.build(dense_cfg, seed=3, device="cpu").tree())
    # the reference's Algorithm 1 onto its own template, jitted (its
    # session's from_dense runs the same function op by op)
    template, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    js = JSession(jcfg, jax.jit(lambda d: JC.convert_dense_to_mpo(d, template))(
        jax.tree.map(jnp.asarray, dense)))
    jconv = jax.tree.map(np.asarray, js.params)
    ts = TSession.from_dense(dense, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32),
             "frames": rng.normal(size=(3, tcfg.frontend_len, tcfg.d_model)).astype(np.float32)}
    converted = {"port": ts.model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy(),
                 "ref": np.asarray(js.model.forward(js.params, _jb(batch))[0])}
    port_cores = {p: [c.clone() for c in cores_to_list(cd)]
                  for p, cd in TSQ.find_mpo_layers(ts.params).items()}
    report = dict(ts.conversion_report)
    passthrough = {k: np.array_equal(ts.params[k].numpy(), dense[k])
                   for k in ("enc_pos", "dec_pos")}
    # the fine-tuning from one tree: the reference's converted cores
    load_jax_params(ts.model, jconv)
    ft = dict(mode="lfa", steps=STEPS, lr=LR, seq_len=SEQ, batch_size=BATCH, log_every=1)
    jr, tr = js.finetune(**ft), ts.finetune(**ft)
    tuned = {"port": jax.tree.map(lambda t: t.clone(), ts.params),
             "ref": jax.tree.map(np.asarray, js.params)}
    cands = sorted(TSQ.candidates(TSQ.find_mpo_layers(ts.params)), key=lambda c: c[-1])
    sq = dict(delta=100.0, max_iters=1, finetune_steps=0, seq_len=SEQ, batch_size=BATCH)
    rho = TSQ.model_compression_ratio(ts.params)
    jev, tev = js.squeeze(**sq), ts.squeeze(**sq)
    root = tmp_path_factory.mktemp("whisper_sessions")
    # what each session held when saved (serving later adds a stage record)
    saved = {"report": ts.report(), "port": (ts.stage, ts.weights_version),
             "ref": (js.stage, js.weights_version)}
    tdir, jdir = ts.save(str(root / "port")), js.save(str(root / "ref"))
    return dict(js=js, ts=ts, dense=dense, jconv=jconv, batch=batch, converted=converted,
                port_cores=port_cores, report=report, passthrough=passthrough, jr=jr, tr=tr,
                tuned=tuned, cands=cands, rho=rho, jev=jev, tev=tev, tdir=tdir, jdir=jdir,
                saved=saved)


def test_from_dense_errors_and_logits_match_reference(lifecycle):
    """Every matrix's conversion error (the encoder's, the decoder's self-
    and cross-attention and MLP, the embedding) against the one the
    reference's converted cores give; the port's reconstructions and the
    converted model's logits against the reference's."""
    ts, dense = lifecycle["ts"], lifecycle["dense"]
    ref = JSQ.find_mpo_layers(lifecycle["jconv"])
    report = lifecycle["report"]
    assert ts._records[0].stage == "from_dense"
    assert set(report) == {"/".join(p[:-1]) for p in ref}
    assert {"encoder/attn/wq", "encoder/mlp/w_down", "decoder/attn/wo", "decoder/xattn/wk",
            "decoder/mlp/w_up", "embed"} <= set(report)
    for name, err in report.items():
        node, w = lifecycle["jconv"], dense
        for k in name.split("/"):
            node, w = node[k], w[k]
        rec = TM.reconstruct_stacked([torch.tensor(c) for c in
                                      cores_to_list(node["cores"])]).numpy()
        assert err == pytest.approx(np.linalg.norm(rec - w["w"]) / np.linalg.norm(w["w"]),
                                    rel=CONV_TOL), name
        got = TM.reconstruct_stacked(lifecycle["port_cores"][tuple(name.split("/")) + ("cores",)])
        assert _max_rel(got.numpy(), rec) <= REC_TOL, name
    assert _max_rel(lifecycle["converted"]["port"], lifecycle["converted"]["ref"]) <= REC_TOL
    # the learned positions pass through Algorithm 1 untouched
    assert lifecycle["passthrough"] == {"enc_pos": True, "dec_pos": True}


def test_lfa_counts_and_finetune_losses_match_reference(lifecycle):
    jr, tr, ts = lifecycle["jr"], lifecycle["tr"], lifecycle["ts"]
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"])
    assert [h["step"] for h in tr["history"]] == list(range(1, STEPS + 1))
    for jh, th in zip(jr["history"], tr["history"], strict=True):
        assert th["loss"] == pytest.approx(jh["loss"], rel=LOSS_TOL)
    port, ref = lifecycle["tuned"]["port"], lifecycle["tuned"]["ref"]
    rl = JSQ.find_mpo_layers(ref)
    for path, cd in TSQ.find_mpo_layers(port).items():
        for name, core in cd.items():
            assert np.abs(core.numpy() - rl[path][name]).max() <= LR * STEPS, (path, name)
    assert np.abs(port["dec_pos"].numpy() - ref["dec_pos"]).max() <= LR * STEPS
    assert ts.mask is not None and not ts.mask["decoder"]["xattn"]["wq"]["cores"]["central"]
    assert ts.mask["enc_pos"] and ts.mask["decoder"]["xattn"]["wq"]["cores"]["c0"]


def test_squeeze_event_matches_reference(lifecycle):
    cands = lifecycle["cands"]
    assert (cands[1][-1] - cands[0][-1]) / cands[0][-1] > GAP, cands[:2]
    jev, tev = lifecycle["jev"], lifecycle["tev"]
    assert len(tev) == len(jev) == 1
    t, j = tev[0], jev[0]
    assert _event(t) == _event(j)
    assert t.predicted_error == pytest.approx(j.predicted_error, rel=EPS_TOL)
    assert t.metric == pytest.approx(j.metric, rel=EPS_TOL, abs=EPS_TOL)
    ts = lifecycle["ts"]
    assert ts.report()["compression_ratio"] < lifecycle["rho"]


def test_served_after_squeeze_matches_reference(lifecycle):
    js, ts, batch = lifecycle["js"], lifecycle["ts"], lifecycle["batch"]
    for wc in (True, False):
        th, jh = ts.serve(3, 20, weight_cache=wc), js.serve(3, 20, weight_cache=wc)
        got = th.prefill(batch).numpy()
        want = np.asarray(jh.prefill(_jb(batch)), np.float32)
        assert _max_rel(got, want) <= SERVE_TOL
        np.testing.assert_array_equal(th.generate(batch, 6).numpy(),
                                      np.asarray(jh.generate(_jb(batch), 6)))


def test_sessions_restore_across_packages(lifecycle):
    """The port's session restored in the reference and the reference's in
    the port: every leaf (the squeezed bond included) bit-equal, the stage,
    version, mask and squeeze events the saving session's; each restored
    session serves the saved one's greedy tokens."""
    js, ts, batch = lifecycle["js"], lifecycle["ts"], lifecycle["batch"]
    rj = JSession.restore(lifecycle["tdir"])
    for a, b in zip(jax.tree.leaves(rj.params), leaves(ts.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (rj.stage, rj.weights_version) == lifecycle["saved"]["port"] == ("squeeze", 2)
    assert [bool(x) for x in jax.tree.leaves(rj.mask)] == list(leaves(ts.mask))
    assert [_event(e) for e in rj.squeeze_history] == [_event(e) for e in ts.squeeze_history]
    rt = TSession.restore(lifecycle["jdir"], device="cpu")
    for a, b in zip(leaves(rt.params), jax.tree.leaves(js.params), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (rt.stage, rt.weights_version) == lifecycle["saved"]["ref"] == ("squeeze", 2)
    assert [_event(e) for e in rt.squeeze_history] == [_event(e) for e in js.squeeze_history]
    assert rt.report()["compression_ratio"] == pytest.approx(
        lifecycle["saved"]["report"]["compression_ratio"], rel=1e-12)
    want = ts.serve(3, 20).generate(batch, 6).numpy()
    np.testing.assert_array_equal(np.asarray(rj.serve(3, 20).generate(_jb(batch), 6)), want)
    np.testing.assert_array_equal(rt.serve(3, 20).generate(batch, 6).numpy(),
                                  np.asarray(js.serve(3, 20).generate(_jb(batch), 6)))

"""The hybrid family (smoke zamba2-7b, 6 layers: shared block 0 serves two
segments) through the paper's lifecycle in the port and the JAX package,
from one dense tree drawn by the port and carried through numpy:
``Session.from_dense`` (Algorithm 1) -> ``finetune`` (LFA, 2 steps) ->
``squeeze`` (Algorithm 2, one iteration) -> ``serve`` -> ``save`` /
``restore`` across the packages; the LFA split at full width.

The fine-tuning is compared from one tree: the reference's converted tree
is carried into the port first, since the two frameworks' SVDs give the
cores other gauges and AdamW's per-element steps are not gauge-invariant
(``tests/test_torch_lifecycle.py``).  Tolerances are that file's and
``tests/test_torch_train.py``'s, for the same reasons (float32, two
frameworks' LAPACK calls):
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
from repro.core import lightweight as JLW
from repro.core import squeeze as JSQ
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import lightweight as TLW
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import load_jax_params
from repro_torch.core.layers import cores_to_list
from repro_torch.core.lightweight import leaves
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import model as TModel
from repro_torch.models import zamba as TZ

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH, LAYERS = "zamba2-7b", 6
SEQ, BATCH, LR, STEPS = 16, 4, 2e-3, 2
CONV_TOL, REC_TOL, EPS_TOL, GAP, LOSS_TOL, SERVE_TOL = 1e-5, 5e-4, 1e-4, 1e-3, 2e-4, 5e-4


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _event(e) -> tuple:
    return (e.step, tuple(e.layer), e.bond, e.new_dim)


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    tcfg = tconfigs.smoke_config(ARCH, num_layers=LAYERS)
    jcfg = jconfigs.smoke_config(ARCH, num_layers=LAYERS)
    dense_cfg = dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, enabled=False))
    dense = jax.tree.map(lambda t: t.detach().numpy(),
                         TModel.build(dense_cfg, seed=3, device="cpu").tree())
    # the reference's Algorithm 1 onto its own template, jitted (its
    # session's from_dense runs the same function op by op, ~4x slower)
    template, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    js = JSession(jcfg, jax.jit(lambda d: JC.convert_dense_to_mpo(d, template))(
        jax.tree.map(jnp.asarray, dense)))
    jconv = jax.tree.map(np.asarray, js.params)
    ts = TSession.from_dense(dense, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    converted = {"port": ts.model({"tokens": torch.from_numpy(prompts)}).numpy(),
                 "ref": np.asarray(js.model.forward(js.params,
                                                    {"tokens": jnp.asarray(prompts)})[0])}
    port_cores = {p: [c.clone() for c in cores_to_list(cd)]
                  for p, cd in TSQ.find_mpo_layers(ts.params).items()}
    report = dict(ts.conversion_report)
    # the fine-tuning from one tree: the reference's converted cores
    load_jax_params(ts.model, jconv)
    ft = dict(mode="lfa", steps=STEPS, lr=LR, seq_len=SEQ, batch_size=BATCH, log_every=1)
    calls = TSSD.ssd_scan_bwd_plain.calls
    jr, tr = js.finetune(**ft), ts.finetune(**ft)
    bwd_calls = TSSD.ssd_scan_bwd_plain.calls - calls
    tuned = {"port": jax.tree.map(lambda t: t.clone(), ts.params),
             "ref": jax.tree.map(np.asarray, js.params)}
    cands = sorted(TSQ.candidates(TSQ.find_mpo_layers(ts.params)), key=lambda c: c[-1])
    sq = dict(delta=100.0, max_iters=1, finetune_steps=0, seq_len=SEQ, batch_size=BATCH)
    rho = TSQ.model_compression_ratio(ts.params)
    jev, tev = js.squeeze(**sq), ts.squeeze(**sq)
    root = tmp_path_factory.mktemp("zamba_sessions")
    # what each session held when saved (serving later adds a stage record)
    saved = {"report": ts.report(), "port": (ts.stage, ts.weights_version),
             "ref": (js.stage, js.weights_version)}
    tdir, jdir = ts.save(str(root / "port")), js.save(str(root / "ref"))
    return dict(js=js, ts=ts, dense=dense, jconv=jconv, prompts=prompts, converted=converted,
                port_cores=port_cores, report=report, jr=jr, tr=tr, bwd_calls=bwd_calls,
                tuned=tuned, cands=cands, rho=rho, jev=jev, tev=tev, tdir=tdir, jdir=jdir,
                saved=saved)


def test_from_dense_errors_and_logits_match_reference(lifecycle):
    """Every matrix's conversion error against the one the reference's
    converted cores give; the port's reconstructions and the converted
    model's logits against the reference's."""
    ts, dense = lifecycle["ts"], lifecycle["dense"]
    ref = JSQ.find_mpo_layers(lifecycle["jconv"])
    report = lifecycle["report"]
    assert ts._records[0].stage == "from_dense"
    assert set(report) == {"/".join(p[:-1]) for p in ref}
    assert {"shared_attn/attn/wq", "shared_attn/mlp/w_down", "mamba/in_proj",
            "mamba/out_proj", "embed"} <= set(report)
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


def test_lfa_counts_and_finetune_losses_match_reference(lifecycle):
    jr, tr, ts = lifecycle["jr"], lifecycle["tr"], lifecycle["ts"]
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"]) == (23_384, 30_040)
    assert [h["step"] for h in tr["history"]] == list(range(1, STEPS + 1))
    for jh, th in zip(jr["history"], tr["history"]):
        assert th["loss"] == pytest.approx(jh["loss"], rel=LOSS_TOL)
    # each layer's SSD scan ran its backward's plain version once a step
    assert lifecycle["bwd_calls"] == STEPS * LAYERS
    port, ref = lifecycle["tuned"]["port"], lifecycle["tuned"]["ref"]
    rl = JSQ.find_mpo_layers(ref)
    for path, cd in TSQ.find_mpo_layers(port).items():
        for name, core in cd.items():
            assert np.abs(core.numpy() - rl[path][name]).max() <= LR * STEPS, (path, name)
    assert ts.mask is not None and not ts.mask["shared_attn"]["attn"]["wq"]["cores"]["central"]


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
    js, ts, prompts = lifecycle["js"], lifecycle["ts"], lifecycle["prompts"]
    for wc in (True, False):
        th, jh = ts.serve(3, 20, weight_cache=wc), js.serve(3, 20, weight_cache=wc)
        got = th.prefill({"tokens": prompts}).numpy()
        want = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}), np.float32)
        assert _max_rel(got, want) <= SERVE_TOL
        np.testing.assert_array_equal(
            th.generate({"tokens": prompts}, 6).numpy(),
            np.asarray(jh.generate({"tokens": jnp.asarray(prompts)}, 6)))


def test_sessions_restore_across_packages(lifecycle):
    """The port's session restored in the reference and the reference's in
    the port: every leaf (the squeezed bond included) bit-equal, the stage,
    version, mask and squeeze events the saving session's; each restored
    session serves the saved one's greedy tokens."""
    js, ts, prompts = lifecycle["js"], lifecycle["ts"], lifecycle["prompts"]
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
    p = {"tokens": prompts}
    want = ts.serve(3, 20).generate(p, 6).numpy()
    np.testing.assert_array_equal(
        np.asarray(rj.serve(3, 20).generate({"tokens": jnp.asarray(prompts)}, 6)), want)
    np.testing.assert_array_equal(
        rt.serve(3, 20).generate(p, 6).numpy(),
        np.asarray(js.serve(3, 20).generate({"tokens": jnp.asarray(prompts)}, 6)))


def test_full_width_lfa_counts_match_reference():
    """The LFA split of full-width zamba2-7b, from abstract trees (nothing
    drawn): the reference's at 9 layers (one segment), the port's at 9, 27
    and 81, each Mamba2 layer adding the same count (the reference's counts
    at 27 and 81, from its ``jax.eval_shape`` at those depths, pinned; its
    tracing at 81 layers takes a minute).  in_proj (3584 -> 14576 = 16 x
    911) keeps nearly all of its entries in its auxiliary core c1 (112, 8,
    911, 64), which trains."""
    jp, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config(ARCH, num_layers=9)).init, jax.random.PRNGKey(0)))
    counts = {}
    for layers in (9, 27, 81):
        with torch.device("meta"):
            tp = TZ.init(torch.Generator(), tconfigs.get_config(ARCH, num_layers=layers))
        counts[layers] = TLW.count_trainable(tp, TLW.trainable_mask(tp, mode="lfa"))
        assert tuple(tp["mamba"]["in_proj"]["cores"]["c1"].shape) == (layers, 112, 8, 911, 64)
    assert counts[9] == JLW.count_trainable(jp, JLW.trainable_mask(jp, mode="lfa"))
    per = [(counts[27][k] - counts[9][k]) // 18 for k in (0, 1)]
    for layers in (27, 81):
        assert counts[layers] == tuple(counts[9][k] + (layers - 9) * per[k] for k in (0, 1))
    assert counts[27] == (1_444_506_784, 1_455_971_488)
    assert counts[81] == (4_312_591_072, 4_338_432_736)

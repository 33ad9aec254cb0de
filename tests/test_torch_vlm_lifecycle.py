"""The vlm family (smoke llava-next-34b) through the paper's lifecycle in the
port and the JAX package, from one dense tree (drawn by the port, carried
through numpy): ``Session.from_dense`` (Algorithm 1) -> ``squeeze``
(Algorithm 2, one LFA re-tune step an iteration, its batches carrying
patches) -> ``finetune`` (LFA; the float32 projector trains) -> ``serve``
(patches + text).

Tolerances are ``tests/test_torch_lifecycle.py``'s, for the same reasons
(float32, two frameworks' LAPACK calls and AdamW's sign flips at gradients
within noise of zero):
- conversion errors within 1e-5 relative; converted reconstructions and
  logits within 5e-4 of their largest magnitude (the smoke bonds truncate
  full-rank Gaussian matrices, where float32 rounding turns the kept
  subspace; 2.1e-4 seen on the logits);
- the squeeze: the same (layer, bond, new_dim), its winner first shown to
  lead its runner-up by more than 1e-3 relative; predicted errors and
  metrics within 1e-4 relative; reconstructions after the re-tune within
  5e-3 of their largest magnitude;
- the fine-tuning after it: losses and aux within 2e-4 relative
  (``tests/test_torch_train.py``'s), the same trainable counts;
- serving: every step's logits within 5e-3 of their largest magnitude (the
  re-tuned reconstructions' gap), greedy tokens identical up to the first
  step the reference's top-2 margin does not clear twice that gap.
"""

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
from repro.core.engine import _reconstruct_stacked
from repro.core.layers import cores_to_list as j_cores_to_list
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import lightweight as TLW
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import jax_tree_to_torch
from repro_torch.core.layers import cores_to_list
from repro_torch.core.lightweight import leaves
from repro_torch.models import model as TModel

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "llava-next-34b"
SEQ, BATCH, LR = 16, 4, 2e-3
CONV_TOL, REC_TOL, EPS_TOL, GAP = 1e-5, 5e-4, 1e-4, 1e-3
REC_TUNED_TOL, METRIC_TOL = 5e-3, 2e-4


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _batch(cfg, b=2, s=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patches": rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim))
            .astype(np.float32)}


@pytest.fixture(scope="module")
def lifecycle():
    tcfg, jcfg = tconfigs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    dense_cfg = dataclasses.replace(tcfg, mpo=dataclasses.replace(tcfg.mpo, enabled=False))
    dense = jax.tree.map(lambda t: t.detach().numpy(),
                         TModel.build(dense_cfg, seed=3, device="cpu").tree())
    # the reference's Algorithm 1 onto its own template, jitted (its session's
    # from_dense runs the same function op by op, several times slower)
    template, _ = JL.split_annotations(jax.eval_shape(JModel.build(jcfg).init,
                                                      jax.random.PRNGKey(0)))
    js = JSession(jcfg, jax.jit(lambda d: JC.convert_dense_to_mpo(d, template))(
        jax.tree.map(jnp.asarray, dense)))
    ts = TSession.from_dense(dense, tcfg, device="cpu")
    batch = _batch(tcfg)
    jbatch = jax.tree.map(jnp.asarray, batch)
    converted = {"port": ts.model({k: torch.from_numpy(v) for k, v in batch.items()}).numpy(),
                 "ref": np.asarray(js.model.forward(js.params, jbatch)[0], np.float32)}
    ref_tree = jax_tree_to_torch(jax.tree.map(np.asarray, js.params))
    counts = (TLW.count_trainable(ts.params, TLW.trainable_mask(ts.params)),
              JLW.count_trainable(js.params, JLW.trainable_mask(js.params)))
    gap = sorted(c[-1] for c in TSQ.candidates(TSQ.find_mpo_layers(ts.params)))[:2]
    assert (gap[1] - gap[0]) / gap[0] > GAP, gap
    pre = {k: v.clone() for k, v in ts.model.state_dict().items()}
    kw = dict(delta=100.0, max_iters=1, finetune_steps=1, lr=LR, seq_len=SEQ, batch_size=BATCH)
    jev, tev = js.squeeze(**kw), ts.squeeze(**kw)
    squeezed = {"port": jax.tree.map(lambda t: t.clone(), ts.params),
                "ref": jax.tree.map(np.asarray, js.params)}
    ft = dict(steps=2, lr=LR, seq_len=SEQ, batch_size=BATCH, log_every=1)
    jr, tr = js.finetune(**ft), ts.finetune(**ft)
    # greedy tokens of both, and every step's logits of both fed the
    # reference's tokens (prefill, then teacher-forced decode)
    jt = np.asarray(js.serve(2, 48).generate(jbatch, 6))
    tt = ts.serve(2, 48).generate(batch, 6).numpy()
    jh, th = js.serve(2, 48), ts.serve(2, 48)
    steps = [(th.prefill(batch).numpy()[:, -1],
              np.asarray(jh.prefill(jbatch), np.float32)[:, -1])]
    for k in range(jt.shape[1] - 1):
        tok = jt[:, k:k + 1]
        steps.append((th.decode(tok)[1].numpy()[:, -1],
                      np.asarray(jh.decode(jnp.asarray(tok))[1], np.float32)[:, -1]))
    served = dict(tokens=(tt, jt), steps=steps)
    return dict(js=js, ts=ts, dense=dense, ref_tree=ref_tree, converted=converted, pre=pre,
                counts=counts,
                jev=jev, tev=tev, squeezed=squeezed, jr=jr, tr=tr, served=served)


def test_from_dense_matches_reference(lifecycle):
    """Every matrix's conversion error (the reference's converted cores,
    reconstructed, against the dense tree) and the converted model's logits
    over patches + text; the projector and the patch path pass through."""
    ts, dense, ref = lifecycle["ts"], lifecycle["dense"], lifecycle["ref_tree"]
    assert ts._records[0].stage == "from_dense"
    assert ts.conversion_report and set(ts.conversion_report) == set(
        "/".join(p[:-1]) for p in TSQ.find_mpo_layers(ref))
    for name, err in ts.conversion_report.items():
        node, w = ref, dense
        for k in name.split("/"):
            node, w = node[k], w[k]
        rec = TM.reconstruct_stacked(cores_to_list(node["cores"])).numpy()
        want = np.linalg.norm(rec - w["w"]) / np.linalg.norm(w["w"])
        assert err == pytest.approx(want, rel=CONV_TOL), name
        key = name.replace("/", ".")
        got = TM.reconstruct_stacked(cores_to_list(
            {c: lifecycle["pre"][f"{key}.cores.{c}"] for c in node["cores"]})).numpy()
        assert _max_rel(got, rec) <= REC_TOL, name
    assert lifecycle["counts"][0] == lifecycle["counts"][1] == (12_352, 16_960)
    np.testing.assert_array_equal(ref["projector"]["w"].numpy(), dense["projector"]["w"])
    np.testing.assert_array_equal(lifecycle["pre"]["projector.w"].numpy(),
                                  dense["projector"]["w"])
    assert _max_rel(lifecycle["converted"]["port"], lifecycle["converted"]["ref"]) <= REC_TOL



def test_squeeze_with_retune_matches_reference(lifecycle):
    """One iteration: the same move (its winner clear by more than 1e-3),
    predicted error, metric (evaluation batches with patches), and every
    matrix's reconstruction after the one-step re-tune."""
    jev, tev = lifecycle["jev"], lifecycle["tev"]
    assert len(tev) == len(jev) == 1
    for j, t in zip(jev, tev):
        assert (t.step, t.layer, t.bond, t.new_dim) == (j.step, j.layer, j.bond, j.new_dim)
        assert t.predicted_error == pytest.approx(j.predicted_error, rel=EPS_TOL)
        assert t.metric == pytest.approx(j.metric, rel=EPS_TOL, abs=EPS_TOL)
    tl = TSQ.find_mpo_layers(lifecycle["squeezed"]["port"])
    jl = JSQ.find_mpo_layers(lifecycle["squeezed"]["ref"])
    assert set(tl) == set(jl)
    for path in tl:
        tcores, jcores = cores_to_list(tl[path]), j_cores_to_list(jl[path])
        assert [tuple(c.shape) for c in tcores] == [tuple(c.shape) for c in jcores], path
        rt = TM.reconstruct_stacked(tcores).numpy()
        assert _max_rel(rt, np.asarray(_reconstruct_stacked(jcores))) <= REC_TUNED_TOL, path


def test_finetune_after_squeeze_matches_reference(lifecycle):
    """Two LFA steps on the squeezed tree: losses and aux, the trainable
    and total counts; the central cores kept since the squeeze, the f32
    projector trained."""
    jr, tr, ts = lifecycle["jr"], lifecycle["tr"], lifecycle["ts"]
    assert (tr["trainable"], tr["total"]) == (jr["trainable"], jr["total"])
    assert tr["trainable"] < tr["total"]
    for jh, th in zip(jr["history"], tr["history"], strict=True):
        for k in ("loss", "aux"):
            assert th[k] == pytest.approx(jh[k], rel=METRIC_TOL, abs=1e-6), k
    now, pre = ts.model.state_dict(), lifecycle["squeezed"]["port"]
    flat = dict(zip([".".join(p) for p in _paths(pre)], leaves(pre)))
    for k, v in now.items():
        if k.endswith(".central"):
            assert torch.equal(v, flat[k]), k
    assert not torch.equal(now["projector.w"], flat["projector.w"])
    assert now["projector.w"].dtype == torch.float32
    assert list(leaves(ts.mask)).count(True) < len(list(leaves(ts.mask)))


def _paths(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def test_serve_after_the_lifecycle_matches_reference(lifecycle):
    """The tuned, squeezed model served from patches + text: the prefill's
    and every decode step's logits (both fed the reference's greedy tokens)
    within ``REC_TUNED_TOL``, and the greedy tokens identical up to the
    first step whose reference top-2 margin is within twice that gap (the
    random smoke weights tie: ``tests/test_torch_lifecycle.py``'s rule)."""
    tt, jt = lifecycle["served"]["tokens"]
    steps = lifecycle["served"]["steps"]
    for k, (a, b) in enumerate(steps):
        assert _max_rel(a, b) <= REC_TUNED_TOL, k
    ref = np.stack([b for _, b in steps], 1)                      # (slot, step, V)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * REC_TUNED_TOL * np.abs(ref).max()
    compared = 0
    for row in range(jt.shape[0]):
        n = int(np.argmin(clear[row])) if not clear[row].all() else jt.shape[1]
        np.testing.assert_array_equal(tt[row, :n], jt[row, :n])
        compared += n
    assert compared > 0


def test_vlm_sessions_restore_across_packages(lifecycle, tmp_path):
    """The converted, squeezed and tuned vlm session saved by either package
    restores in the other: every leaf (the squeezed bonds and the f32
    projector included) bit-equal, stage, version and mask."""
    js, ts = lifecycle["js"], lifecycle["ts"]
    r = JSession.restore(ts.save(str(tmp_path / "port")))
    for a, b in zip(jax.tree.leaves(r.params), leaves(ts.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (r.stage, r.weights_version) == (ts.stage, ts.weights_version)
    assert [bool(m) for m in jax.tree.leaves(r.mask)] == list(leaves(ts.mask))
    t = TSession.restore(js.save(str(tmp_path / "ref")), device="cpu")
    for a, b in zip(leaves(t.params), jax.tree.leaves(js.params), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t.params["projector"]["w"].dtype == torch.float32
    assert (t.stage, t.weights_version) == (js.stage, js.weights_version)
    assert list(leaves(t.mask)) == [bool(m) for m in jax.tree.leaves(js.mask)]

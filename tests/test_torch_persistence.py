"""Session persistence in the port — ``finetune(ckpt_dir=...)``,
``squeeze(ckpt_dir=...)`` and ``Session.save`` / ``Session.restore`` —
against itself (a preempted run resumed against an uninterrupted one) and
against the JAX package's ``Session`` (a session saved by either restores
in the other; a squeeze journal the reference wrote resumes in the port).

Tolerances:
- resumed against uninterrupted, and save/restore in one package: exact
  (the same computation on the same bits, each leaf's bits stored).
- cross-restore: every leaf bit-equal to the saving package's (float32
  smoke configs; the files hold their bits); prefill logits within 5e-4 of
  their largest magnitude (``tests/test_torch_lifecycle.py``'s serving
  tolerance: two frameworks' float32 sums, 2e-4 observed there); greedy
  tokens identical.
- cross-resume: the (layer, bond, new_dim) sequence identical to the
  reference's uninterrupted run (the lifecycle tests show each winner of
  this tree's moves leads by more than 1e-3); metrics within 1e-4."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.models import model as JModel
from repro.resilience import faults as jfaults
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import jax_tree_to_torch
from repro_torch.core.lightweight import leaves
from repro_torch.resilience import faults
from repro_torch.resilience.journal import SqueezeJournal

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

SEQ, BATCH = 16, 4
SERVE_TOL, METRIC_TOL = 5e-4, 1e-4
SQUEEZE_KW = dict(delta=100.0, max_iters=3, seq_len=SEQ, batch_size=BATCH)


def _dense_cfg(cfg):
    return dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _state(s) -> dict:
    return {k: v.clone() for k, v in s.model.state_dict().items()}


def _same_params(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
        for k in a)


def _arrays(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _event(e) -> tuple:
    return (e.step, tuple(e.layer), e.bond, e.new_dim, e.predicted_error, e.metric)


def _records(s) -> list:
    return [(r.stage, r.seconds, r.info) for r in s._records]


# --------------------------------------------------------------------------
# resume against an uninterrupted run (the port against itself)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["bert-base", "qwen3-14b", "mamba2-130m"])
def test_preempted_finetune_resumes_bit_identical(tmp_path, arch):
    """Preempted at step 2 of 4: the SIGTERM-drain save is step 2 (no
    periodic one at ``ckpt_every=100``), and the rerun resumes there.  The
    final checkpoints of the two runs (parameters and AdamW state, the step
    count included) and the models' parameters are bit-identical."""
    kw = dict(steps=4, seq_len=8, batch_size=2, ckpt_every=100)
    ref = TSession.init(arch, device="cpu")
    ref.finetune(ckpt_dir=str(tmp_path / "ref"), **kw)
    s = TSession.init(arch, device="cpu")
    ck = str(tmp_path / "ck")
    with faults.fault_scope(faults.FaultPlan(preempt_finetune_step=2)):
        with pytest.raises(faults.Preemption):
            s.finetune(ckpt_dir=ck, **kw)
    assert CheckpointManager(ck).latest_step() == 2
    assert not _same_params(_state(s), _state(ref))
    rep = s.finetune(ckpt_dir=ck, **kw)
    assert [h["step"] for h in rep["history"]] == [3, 4]     # first step and every 4th
    assert _same_params(_state(s), _state(ref))
    got, want = _arrays(f"{ck}/step_4/arrays.npz"), _arrays(tmp_path / "ref/step_4/arrays.npz")
    assert got.keys() == want.keys()
    assert any(k.startswith(".opt_state/.inner/") for k in got)
    assert got[".opt_state/.step"] == want[".opt_state/.step"] == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _preempted_squeeze(tmp_path, arch):
    kw = dict(SQUEEZE_KW, finetune_steps=2)
    ref = TSession.init(arch, device="cpu")
    ref_hist = ref.squeeze(**kw)
    s = TSession.init(arch, device="cpu")
    jdir = str(tmp_path / "journal")
    with faults.fault_scope(faults.FaultPlan(preempt_squeeze_iter=1)):
        with pytest.raises(faults.Preemption):
            s.squeeze(ckpt_dir=jdir, **kw)
    _, nxt, hist, _ = SqueezeJournal(jdir).load(s.params)
    assert nxt == 1 and hist == ref_hist[:1]
    version = s.weights_version
    out = s.squeeze(ckpt_dir=jdir, **kw)
    assert out == ref_hist and len(out) == 3
    assert [e.seconds for e in out[:1]] == [hist[0].seconds]   # the journaled one
    assert _same_params(_state(s), _state(ref))
    assert TSQ.model_compression_ratio(s.params) == TSQ.model_compression_ratio(ref.params)
    # installing the journaled tree and the squeeze's result: two mutations
    assert s.weights_version == version + 2


def test_preempted_squeeze_resumes_identically(tmp_path):
    """Preempted at iteration 1 (2-step re-tunes): the journal holds
    iteration 0, and the rerun installs it and reproduces the uninterrupted
    run's history (all but ``seconds``), tree and rho exactly."""
    _preempted_squeeze(tmp_path, "bert-base")


def test_preempted_ssm_squeeze_resumes_identically(tmp_path):
    """The same for mamba2-130m, whose re-tunes run the SSD scan's backward:
    the resumed run reproduces the uninterrupted one bit for bit."""
    _preempted_squeeze(tmp_path, "mamba2-130m")


# --------------------------------------------------------------------------
# save / restore
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The same dense tree (the reference's smoke bert-base, PRNGKey(0))
    through from_dense -> finetune -> squeeze in both packages, each saved."""
    jcfg, tcfg = jconfigs.smoke_config("bert-base"), tconfigs.smoke_config("bert-base")
    dense, _ = JModel.build(_dense_cfg(jcfg)).init_params(jax.random.PRNGKey(0))
    kw = dict(SQUEEZE_KW, max_iters=2, finetune_steps=0)
    js = JSession.from_dense(dense, jcfg)
    js.finetune(steps=2, seq_len=SEQ, batch_size=BATCH)
    js.squeeze(**kw)
    ts = TSession.from_dense(jax.tree.map(np.asarray, dense), tcfg, device="cpu")
    ts.finetune(steps=2, seq_len=SEQ, batch_size=BATCH)
    ts.squeeze(**kw)
    root = tmp_path_factory.mktemp("sessions")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 7)).astype(np.int32)
    # what each session held when saved (serving later adds a stage record)
    saved = {name: dict(stage=s.stage, version=s.weights_version, records=_records(s))
             for name, s in (("js", js), ("ts", ts))}
    return dict(js=js, ts=ts, jdir=js.save(str(root / "ref")), tdir=ts.save(str(root / "port")),
                dense=dense, prompts=prompts, saved=saved, report=ts.report())


def _as_saved(s) -> dict:
    return dict(stage=s.stage, version=s.weights_version, records=_records(s))


def _serve(s, prompts, jax_side: bool):
    h = s.serve(3, 16)
    if jax_side:
        p = {"tokens": jnp.asarray(prompts)}
        return np.asarray(h.prefill(p), np.float32), np.asarray(h.generate(p, 6))
    p = {"tokens": prompts}
    return h.prefill(p).numpy(), h.generate(p, 6).numpy()


def test_save_restore_round_trip(sessions, tmp_path):
    """from_dense -> finetune -> squeeze, saved and restored in the port:
    stage, version, records, mask, conversion report, history and every
    leaf (squeezed bonds included) equal; the same greedy tokens and prefill
    logits; a save of the restored session reads back the same again."""
    ts = sessions["ts"]
    r = TSession.restore(sessions["tdir"], device="cpu")
    assert _as_saved(r) == sessions["saved"]["ts"]
    assert (r.stage, r.weights_version) == ("squeeze", 2)
    assert r.report() == sessions["report"]
    assert r.mask == ts.mask and r.conversion_report == ts.conversion_report
    assert r.squeeze_history == ts.squeeze_history
    assert [e.seconds for e in r.squeeze_history] == [e.seconds for e in ts.squeeze_history]
    assert _same_params(_state(r), _state(ts))
    assert r.device.type == "cpu"
    got, want = _serve(r, sessions["prompts"], False), _serve(ts, sessions["prompts"], False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    again = TSession.restore(r.save(str(tmp_path / "again")), device="cpu")
    assert _same_params(_state(again), _state(ts)) and _as_saved(again) == _as_saved(r)


def test_restore_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest"):
        TSession.restore(str(tmp_path / "nope"), device="cpu")
    d = tmp_path / "bad"
    d.mkdir()
    (d / "session.json").write_text('{"format": 999}')
    with pytest.raises(ValueError, match="format"):
        TSession.restore(str(d), device="cpu")


def test_restore_defaults_to_the_card(sessions):
    """No silent move to the CPU: without ``device`` the restore builds on
    the card, and raises where there is none."""
    if torch.cuda.is_available():
        assert TSession.restore(sessions["tdir"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSession.restore(sessions["tdir"])


def _tune_file(directory) -> dict:
    """A saved directory's ``autotune.json`` and the manifest's count of it."""
    import json
    with open(os.path.join(directory, "autotune.json")) as f:
        tune = json.load(f)
    with open(os.path.join(directory, "session.json")) as f:
        count = json.load(f)["autotune_entries"]
    assert count == len(tune["entries"])
    return tune


def test_reference_session_restores_in_the_port(sessions):
    """The reference's ``autotune.json`` (its own cache format) is there
    and counted; the port's importer takes nothing from it."""
    from repro.kernels import autotune as jautotune
    from repro_torch.kernels import autotune as tautotune
    js = sessions["js"]
    tune = _tune_file(sessions["jdir"])
    assert tune["version"] == jautotune.CACHE_VERSION != tautotune.CACHE_VERSION
    assert tautotune.import_cache(os.path.join(sessions["jdir"], "autotune.json"))[
        "imported"] == 0
    r = TSession.restore(sessions["jdir"], device="cpu")
    want = jax_tree_to_torch(jax.tree.map(np.asarray, js.params))
    got = r.params
    assert list(leaves(got)) and len(list(leaves(got))) == len(list(leaves(want)))
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert _as_saved(r) == _as_saved(JSession.restore(sessions["jdir"]))
    assert (r.stage, r.weights_version) == (sessions["saved"]["js"]["stage"],
                                           sessions["saved"]["js"]["version"])
    assert [r_.stage for r_ in r._records] == ["from_dense", "finetune", "squeeze"]
    assert list(leaves(r.mask)) == [bool(x) for x in jax.tree.leaves(js.mask)]
    assert r.conversion_report == js.conversion_report
    assert [_event(e) for e in r.squeeze_history] == [_event(e) for e in js.squeeze_history]
    assert all(e.seconds == {} for e in r.squeeze_history)
    tl, tt = _serve(r, sessions["prompts"], False)
    jl, jt = _serve(js, sessions["prompts"], True)
    assert _max_rel(tl, jl) <= SERVE_TOL
    np.testing.assert_array_equal(tt, jt)


def test_port_session_restores_in_the_reference(sessions):
    """The port writes ``autotune.json`` in its own cache format, counted in
    the manifest; the reference's importer takes nothing from it."""
    from repro.kernels import autotune as jautotune
    from repro_torch.kernels import autotune as tautotune
    ts = sessions["ts"]
    tune = _tune_file(sessions["tdir"])
    assert tune["version"] == tautotune.CACHE_VERSION != jautotune.CACHE_VERSION
    assert jautotune.import_cache(os.path.join(sessions["tdir"], "autotune.json"))[
        "imported"] == 0
    r = JSession.restore(sessions["tdir"])
    for a, b in zip(jax.tree.leaves(r.params), leaves(ts.params), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert _as_saved(r) == sessions["saved"]["ts"]
    assert [bool(x) for x in jax.tree.leaves(r.mask)] == list(leaves(ts.mask))
    assert r.conversion_report == ts.conversion_report
    assert [_event(e) for e in r.squeeze_history] == [_event(e) for e in ts.squeeze_history]
    jl, jt = _serve(r, sessions["prompts"], True)
    tl, tt = _serve(ts, sessions["prompts"], False)
    assert _max_rel(jl, tl) <= SERVE_TOL
    np.testing.assert_array_equal(jt, tt)


def test_reference_journal_resumes_in_the_port(sessions, tmp_path):
    """The reference's squeeze, preempted at iteration 1 with no re-tune,
    journals iteration 0; the port resumes from that journal and makes the
    reference's uninterrupted moves."""
    jcfg = jconfigs.smoke_config("bert-base")
    kw = dict(SQUEEZE_KW, finetune_steps=0)
    whole = JSession.from_dense(sessions["dense"], jcfg).squeeze(**kw)
    jdir = str(tmp_path / "journal")
    pre = JSession.from_dense(sessions["dense"], jcfg)
    with jfaults.fault_scope(jfaults.FaultPlan(preempt_squeeze_iter=1)):
        with pytest.raises(jfaults.Preemption):
            pre.squeeze(ckpt_dir=jdir, **kw)
    ts = TSession.from_dense(jax.tree.map(np.asarray, sessions["dense"]),
                             tconfigs.smoke_config("bert-base"), device="cpu")
    hist = ts.squeeze(ckpt_dir=jdir, **kw)
    assert len(hist) == len(whole) == 3
    assert [(e.layer, e.bond, e.new_dim) for e in hist] == \
        [(tuple(e.layer), e.bond, e.new_dim) for e in whole]
    for t, j in zip(hist, whole):
        assert t.metric == pytest.approx(j.metric, abs=METRIC_TOL)
    # the journaled event is the reference's own, read back
    assert _event(hist[0]) == _event(whole[0]) and hist[0].seconds == {}

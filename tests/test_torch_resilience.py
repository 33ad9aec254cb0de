"""The port's persistence layer on its own — ``resilience.faults``,
``checkpoint.manager`` and ``resilience.journal`` — against the JAX
package's where the two must agree (the chaos grammar, the array keys of a
train state, a journal record), and against the durability contract the
reference's chaos suite (``tests/test_resilience.py``) pins.

Every comparison is exact (``torch.equal`` / ``==``): a checkpoint stores
each leaf's bits (bfloat16 widened to float32, which is exact), so nothing
here has a tolerance."""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.optim import optimizers as JOpt
from repro.resilience import faults as jfaults
from repro.resilience import journal as jjournal
from repro.train.steps import TrainState as JTrainState
from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.squeeze import SqueezeEvent
from repro_torch.optim import optimizers as TOpt
from repro_torch.resilience import faults
from repro_torch.resilience.journal import SqueezeJournal, event_from_json, event_to_json
from repro_torch.resilience.state import atomic_write_json
from repro_torch.train.steps import TrainState

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

SPECS = ["preempt-finetune:3", "preempt-squeeze:2", "crash-ckpt:mid_write",
         "crash-ckpt:pre_latest:5", "io:ckpt:3", "nan-decode:1", "nan-decode:1:0",
         "deny-pages:2", "flash-raise", "expire-admit:2", "kill-pool:1:40",
         "trip-pool:0", "shed-storm:3"]
BAD_SPECS = ["bogus:1", "crash-ckpt:nowhere", "preempt-squeeze", "io:ckpt",
             "kill-pool:1", "preempt-finetune:x", "crash-ckpt"]


def _tree(scale=1.0):
    return {"a": torch.arange(6.0).reshape(2, 3) * scale,
            "b": torch.ones(4, dtype=torch.int32)}


def _equal(t1, t2) -> bool:
    w1, w2 = list(M._walk(t1)), list(M._walk(t2))
    return [k for k, _ in w1] == [k for k, _ in w2] and all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for (_, a), (_, b) in zip(w1, w2))


# --------------------------------------------------------------------------
# FaultPlan
# --------------------------------------------------------------------------


def _fields(plan) -> dict:
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}


@pytest.mark.parametrize("specs", [[s] for s in SPECS] + [SPECS])
def test_fault_plan_parse_matches_reference(specs):
    plan = faults.FaultPlan.parse(specs)
    assert _fields(plan) == _fields(jfaults.FaultPlan.parse(specs))
    assert plan != faults.FaultPlan()          # every spec sets a field


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_parse_rejects_what_the_reference_rejects(spec):
    with pytest.raises(ValueError, match="chaos spec"):
        jfaults.FaultPlan.parse([spec])
    with pytest.raises(ValueError, match="chaos spec"):
        faults.FaultPlan.parse([spec])


def test_checks_are_noops_without_plan():
    assert faults.active() is None
    faults.step_tick("finetune", 0)
    faults.step_tick("squeeze", 0)
    faults.crash_point("ckpt:pre_latest", 1)
    faults.io_check("ckpt")
    plan = faults.FaultPlan(preempt_finetune_step=1)
    with faults.fault_scope(plan):
        assert faults.active() is plan
        faults.step_tick("finetune", 0)
        faults.step_tick("squeeze", 1)       # another site's index
        with pytest.raises(faults.Preemption):
            faults.step_tick("finetune", 1)
    assert faults.active() is None
    # BaseException: an ``except Exception`` recovery path does not absorb it
    assert not issubclass(faults.Preemption, Exception)
    assert not issubclass(faults.CrashPoint, Exception)


def test_faults_module_needs_nothing_beyond_the_standard_library():
    """As the reference's, the chaos module loads without torch (or numpy)."""
    path = os.path.join(os.path.dirname(faults.__file__), "faults.py")
    code = ("import importlib.util, sys\n"
            "sys.modules['torch'] = sys.modules['numpy'] = None\n"
            f"spec = importlib.util.spec_from_file_location('f', {path!r})\n"
            "m = sys.modules['f'] = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "assert m.FaultPlan.parse(['preempt-squeeze:2']).preempt_squeeze_iter == 2\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stderr


# --------------------------------------------------------------------------
# CheckpointManager: crash consistency, retries, async writer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["mid_write", "pre_latest"])
def test_crash_restores_the_previous_step(tmp_path, where):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, async_save=False)
    mgr.save(1, _tree(1.0))
    with faults.fault_scope(faults.FaultPlan(crash_ckpt=where)):
        with pytest.raises(faults.CrashPoint):
            mgr.save(2, _tree(2.0))
    fresh = CheckpointManager(d)
    assert fresh.latest_step() == 1
    tree, meta = fresh.restore(None, _tree())
    assert meta["step"] == 1 and _equal(tree, _tree(1.0))
    # a retry after the crash publishes normally and flips the link
    fresh.save(2, _tree(2.0), block=True)
    assert fresh.latest_step() == 2
    assert _equal(fresh.restore(None, _tree())[0], _tree(2.0))


def test_transient_io_errors_are_retried_then_surface(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False, io_backoff=0.001)
    plan = faults.FaultPlan(io_errors={"ckpt": 2})
    with faults.fault_scope(plan):
        mgr.save(1, _tree(3.0))
    assert plan.io_errors["ckpt"] == 0
    assert _equal(mgr.restore(1, _tree())[0], _tree(3.0))
    # more failures in a row than the budget (3 retries): the error surfaces
    with faults.fault_scope(faults.FaultPlan(io_errors={"ckpt": 10})):
        with pytest.raises(faults.InjectedIOError):
            mgr.save(2, _tree(4.0))
    assert mgr.latest_step() == 1


def test_async_saves_serialize_and_keep_k(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    write, active, most = mgr._write, [0], [0]
    lock = threading.Lock()

    def slow_write(*args):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        time.sleep(0.02)
        write(*args)
        with lock:
            active[0] -= 1

    mgr._write = slow_write
    for s in range(1, 6):
        mgr.save(s, _tree(float(s)))
    mgr.wait()
    assert most[0] == 1                  # never two writers at once
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert not any(n.startswith(".tmp_step_") for n in os.listdir(d))
    assert _equal(mgr.restore(4, _tree())[0], _tree(4.0))


def test_failed_async_save_reraises_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), io_retries=0)
    with faults.fault_scope(faults.FaultPlan(io_errors={"ckpt": 5})):
        mgr.save(1, _tree())
        mgr._thread.join(timeout=60)
        assert not mgr._thread.is_alive()
    with pytest.raises(faults.InjectedIOError):
        mgr.wait()
    mgr.wait()                   # raised once, then cleared
    mgr.save(2, _tree(2.0), block=True)
    assert mgr.latest_step() == 2


def test_async_snapshot_is_a_copy(tmp_path):
    """The optimizers write the parameters in place right after a save: the
    checkpoint must hold the values at the call, not a view of the tensor."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    saved = {"p": t.clone(), "q": b.clone()}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    write, go = mgr._write, threading.Event()
    mgr._write = lambda *a: go.wait(60) and write(*a)     # the writer runs late
    mgr.save(1, {"p": t, "q": b})
    t.add_(1.0)                  # the next step, before the writer runs
    b.mul_(3.0)
    go.set()
    mgr.wait()
    got, _ = mgr.restore(1, {"p": t, "q": b})
    assert _equal(got, saved)


def test_bf16_none_and_int_leaves_round_trip(tmp_path):
    """A bf16 leaf comes back bit-exact in bf16, a frozen leaf's ``None``
    optimizer state writes nothing and comes back ``None``, and
    ``OptState.step`` (a Python int) comes back an int."""
    g = torch.Generator().manual_seed(0)
    params = {"c0": torch.randn(3, 4, generator=g).bfloat16(),
              "central": torch.randn(5, generator=g).bfloat16()}
    opt = TOpt.adamw(1e-3, mask={"c0": True, "central": False})
    state = TrainState(params, opt.init(params))
    state = TrainState(params, state.opt_state._replace(step=7))
    state.opt_state.inner["c0"]["mu"].normal_(generator=g)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(3, state)
    with np.load(tmp_path / "ck" / "step_3" / "arrays.npz") as z:
        assert sorted(z.files) == [".opt_state/.inner/c0/mu", ".opt_state/.inner/c0/nu",
                                   ".opt_state/.step", ".params/c0", ".params/central"]
        assert z[".params/c0"].dtype == np.float32
    template = TrainState({k: torch.zeros_like(v) for k, v in params.items()},
                          opt.init(params))
    got, meta = mgr.restore(None, template)
    assert meta["step"] == 3
    assert got.params["c0"].dtype == torch.bfloat16
    assert got.opt_state.inner["central"] is None
    assert type(got.opt_state.step) is int and got.opt_state.step == 7
    assert _equal(got, state)
    # written into the live tensors (the resume path): same objects, saved bits
    live = M.copy_into(template, got)
    assert live.params["c0"] is template.params["c0"] and _equal(live, state)


def test_restore_raises_on_missing_or_extra_keys_and_copy_into_on_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, _tree())
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(1, {**_tree(), "c": torch.zeros(1)})
    with pytest.raises(KeyError, match="extra"):
        mgr.restore(1, {"a": torch.zeros(2, 3)})
    live = {"a": torch.zeros(2, 3), "b": torch.zeros(5, dtype=torch.int32)}
    with pytest.raises(ValueError, match="live"):
        M.copy_into(live, _tree())
    assert not live["a"].any()       # nothing written before the check failed


def test_train_state_keys_and_values_read_in_the_reference(tmp_path):
    """The port's TrainState checkpoint has the reference's keys and
    restores in the reference's manager (and the reverse)."""
    g = torch.Generator().manual_seed(1)
    params = {"a": {"c0": torch.randn(2, 3, generator=g), "central": torch.randn(4, generator=g)}}
    mask = {"a": {"c0": True, "central": False}}
    opt = TOpt.adamw(1e-3, mask=mask)
    state = TrainState(params, opt.init(params)._replace(step=5))
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(2, state)
    jp = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), params)
    jstate = JTrainState(jp, JOpt.adamw(1e-3, mask=mask).init(jp))
    got, _ = JManager(str(tmp_path / "t"), async_save=False).restore(2, jstate)
    assert int(got.opt_state.step) == 5
    np.testing.assert_array_equal(np.asarray(got.params["a"]["c0"]), params["a"]["c0"].numpy())
    # the reverse: the reference's checkpoint into the port's template
    JManager(str(tmp_path / "j"), async_save=False).save(
        1, JTrainState(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params), got.opt_state))
    back, _ = CheckpointManager(str(tmp_path / "j")).restore(1, state)
    assert back.opt_state.step == 5 and _equal(back.params, params)


# --------------------------------------------------------------------------
# the squeeze journal
# --------------------------------------------------------------------------


def test_journal_loads_what_it_recorded_squeezed_shapes_included(tmp_path):
    g = torch.Generator().manual_seed(2)
    template = {"l": {"cores": {"c0": torch.zeros(1, 4, 3, 8, dtype=torch.bfloat16),
                                "central": torch.zeros(8, 2, 2, 1, dtype=torch.bfloat16)}},
                "n": torch.zeros(3)}
    squeezed = {"l": {"cores": {"c0": torch.randn(1, 4, 3, 6, generator=g).bfloat16(),
                                "central": torch.randn(6, 2, 2, 1, generator=g).bfloat16()}},
                "n": torch.randn(3, generator=g)}
    ev = SqueezeEvent(0, ("l", "cores"), 0, 6, 0.125, 0.75, {"spectra": 0.5})
    j = SqueezeJournal(str(tmp_path / "j"))
    assert j.load(template) is None
    j.record(0, squeezed, [ev], 0.8)
    params, nxt, hist, base = SqueezeJournal(str(tmp_path / "j")).load(template)
    assert (nxt, base) == (1, 0.8) and hist == [ev] and hist[0].seconds == {"spectra": 0.5}
    assert params["l"]["cores"]["c0"].shape == (1, 4, 3, 6)
    assert _equal(params, squeezed)
    # the reference's journal reads the port's record, and the reverse
    jp, jnxt, jhist, jbase = jjournal.SqueezeJournal(str(tmp_path / "j")).load(
        jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), template))
    assert (jnxt, jbase) == (1, 0.8) and jhist[0].layer == ev.layer
    assert np.asarray(jp["l"]["cores"]["c0"]).shape == (1, 4, 3, 6)


def test_events_equal_but_for_seconds_and_reference_records_read():
    a = SqueezeEvent(1, ("layers", "wq", "cores"), 2, 7, 0.5, 0.9, {"eval": 1.0})
    b = dataclasses.replace(a, seconds={"eval": 2.0, "retune": 3.0})
    assert a == b and a != dataclasses.replace(a, metric=0.8)
    ref = jjournal.event_to_json(jjournal.SqueezeEvent(1, ("layers", "wq", "cores"), 2, 7,
                                                        0.5, 0.9))
    assert "seconds" not in ref
    got = event_from_json(ref)
    assert got == a and got.seconds == {}
    assert event_from_json(event_to_json(b)).seconds == b.seconds


def test_manifest_refuses_non_python_values(tmp_path):
    """Stage records must hold Python values: the manifest writer does not
    absorb a tensor or a numpy scalar."""
    for bad in (torch.tensor(1.0), np.float32(1.0)):
        with pytest.raises(TypeError):
            atomic_write_json(str(tmp_path / "m.json"), {"x": bad})
    atomic_write_json(str(tmp_path / "m.json"), {"x": 1.0})
    assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]

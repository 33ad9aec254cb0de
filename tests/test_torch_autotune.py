"""The port's measured autotuner (``repro_torch.kernels.autotune``) and its
wiring: the nine behaviours of ``tests/test_autotune.py`` on the port, the
race itself, shared cache files, shipped artifacts across the packages,
and saved sessions.

``REPRO_TORCH_AUTOTUNE_MEASURE=1`` forces measuring on the CPU, where the
candidates are the factorized chain and the rebuild (a kernel candidate
exists on CUDA only); each test points ``REPRO_TORCH_AUTOTUNE_CACHE`` at a
temporary file.  A disk verdict ``kernel@64`` executes on the CPU through
the kernel mode's plain versions; the reference's engine, given the same
verdict in its own cache, runs its Pallas kernel in interpret mode.  The
two agree within 1e-5 of the largest output and of each core's largest
gradient: float32 sums over at most 32 terms in another order (~1e-7
relative observed)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import layers as JL
from repro.kernels import autotune as JA
from repro_torch import Session as TSession
from repro_torch.core import engine as TE
from repro_torch.core import layers as TL
from repro_torch.core import mpo as TM
from repro_torch.kernels import autotune as TA
from repro_torch.kernels import mpo_linear as TMK

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

CFG = TL.MPOConfig()
# the reference test's shapes: I = 32, J = 512
SHAPES = ((1, 2, 4, 4), (4, 4, 4, 4), (4, 4, 32, 1))
TOKENS = 16
PARITY_TOL = 1e-5
# full-width bert-base's attention matrix (768 -> 768, the tensor-core
# route in both dtypes) and smoke bert-base's (32 -> 32, csrc/mpo_linear.cu
# in float32, no bf16 route)
BERT_ATTN = ((1, 3, 3, 9), (9, 4, 4, 64), (64, 4, 4, 64), (64, 4, 4, 16), (16, 4, 4, 1))
SMOKE_ATTN = ((1, 4, 4, 8), (8, 2, 2, 8), (8, 2, 2, 8), (8, 2, 2, 4), (4, 2, 2, 1))


def _fresh():
    """A new tuner and plan memo over the same cache file: a new process."""
    TE.clear_plan_cache()
    return TA.reset_tuner()


@pytest.fixture
def tuned(tmp_path, monkeypatch):
    """Measuring forced on, the cache a temporary file; the process-wide
    tuner and plan memo restored afterwards."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(TA.ENV_CACHE, path)
    monkeypatch.setenv(TA.ENV_MEASURE, "1")
    _fresh()
    yield path
    TE.clear_plan_cache()
    TA.reset_tuner()


def _seed(path, key, mode, block_m, timings=None, version=TA.CACHE_VERSION):
    with open(path, "w") as f:
        json.dump({"version": version, "entries": {key: {
            "mode": mode, "block_m": block_m, "timings": timings or {}}}}, f)


def _stubs(delays):
    """A ``candidates_fn`` of thunks that sleep their delays, counting calls."""
    calls = {k: 0 for k in delays}

    def build(shapes, tokens, phase, dtype, device):
        def thunk(label):
            calls[label] += 1
            time.sleep(delays[label])
        return [(label, lambda label=label: thunk(label)) for label in delays]
    return build, calls


# --------------------------------------------------------------------------
# the nine behaviours of the reference's tests
# --------------------------------------------------------------------------


def test_warm_cache_same_plan_zero_timing_runs(tuned):
    eng = TE.engine_for(CFG)
    p1 = eng.plan(SHAPES, TOKENS, "train")
    t1 = TA.get_tuner()
    assert p1.tuned and t1.timing_runs == 2        # factorized, reconstruct
    assert "(measured)" in p1.reason and p1.mode in ("factorized", "reconstruct")
    t2 = _fresh()
    p2 = eng.plan(SHAPES, TOKENS, "train")
    assert t2.timing_runs == 0 and "(disk)" in p2.reason
    assert (p2.mode, p2.block_m, p2.tuned) == (p1.mode, p1.block_m, True)
    raw = json.load(open(tuned))
    assert raw["version"] == TA.CACHE_VERSION
    ent = raw["entries"][TA.make_key(SHAPES, TOKENS, "train", "float32")]
    assert ent["mode"] == p1.mode and ent["block_m"] == 0
    assert set(ent["timings"]) == {"factorized", "reconstruct"}


def test_corrupted_cache_is_ignored_and_retuned(tuned):
    with open(tuned, "w") as f:
        f.write("{this is not json")
    tuner = _fresh()
    assert TE.engine_for(CFG).plan(SHAPES, TOKENS, "prefill").tuned
    assert tuner.timing_runs > 0
    raw = json.load(open(tuned))
    assert TA.make_key(SHAPES, TOKENS, "prefill", "float32") in raw["entries"]


@pytest.mark.parametrize("version,mode,block_m", [
    (TA.CACHE_VERSION + 999, "kernel", 64),      # stale file
    (TA.CACHE_VERSION, "kernel", 7),             # a tile no kernel is built for
    (TA.CACHE_VERSION, "factorized", 64),        # a tile on a mode without one
    (TA.CACHE_VERSION, "flash", 0),              # not a mode of this race
    (TA.CACHE_VERSION, "kernel", True),          # not an int
])
def test_stale_or_malformed_entries_are_ignored(tuned, version, mode, block_m):
    key = TA.make_key(SHAPES, TOKENS, "prefill", "float32")
    _seed(tuned, key, mode, block_m, version=version)
    tuner = _fresh()
    plan = TE.engine_for(CFG).plan(SHAPES, TOKENS, "prefill")
    assert plan.tuned and tuner.timing_runs > 0 and "(measured)" in plan.reason
    assert plan.block_m == 0


def test_cpu_defaults_to_analytic(tmp_path, monkeypatch):
    """Unforced, measuring happens for a CUDA device the process has, so
    the CPU plans analytically: no timing, no cache file."""
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv(TA.ENV_CACHE, path)
    monkeypatch.delenv(TA.ENV_MEASURE, raising=False)
    assert not TA.should_measure("cpu")
    assert TA.should_measure("cuda") == torch.cuda.is_available()
    tuner = _fresh()
    try:
        plan = TE.engine_for(CFG).plan(SHAPES, 4096, "train")
        assert not plan.tuned and tuner.timing_runs == 0 and plan.block_m == 0
        assert "FLOPs" in plan.reason
        assert not os.path.exists(path)
    finally:
        _fresh()


def test_measure_disable_env_wins(tmp_path, monkeypatch):
    monkeypatch.setenv(TA.ENV_CACHE, str(tmp_path / "autotune.json"))
    monkeypatch.setenv(TA.ENV_MEASURE, "0")
    assert not TA.should_measure("cuda") and not TA.should_measure("cpu")
    tuner = _fresh()
    try:
        # a CUDA plan, made here without a card: the analytic gate decides
        plan = TE.engine_for(CFG).plan(BERT_ATTN, 1024, "prefill", "bfloat16", "cuda")
        assert (plan.mode, plan.tuned, tuner.timing_runs) == ("kernel", False, 0)
        assert "not measured" in plan.reason
    finally:
        _fresh()


def test_candidates_dedupe_by_effective_tile():
    """A pure function of the shapes, rows, phase, dtype and device type:
    the tensor-core route races 16, 64 and 128 rows, ``csrc/mpo_linear.cu``
    64 and 128; at 16 rows or fewer (64 for the narrow route) one tile is
    left; nothing off CUDA or where the gate refuses the shapes."""
    for phase in ("prefill", "train"):
        for dtype in ("bfloat16", "float32"):
            cand = lambda m: TA._block_m_candidates(BERT_ATTN, m, phase, dtype, "cuda")
            assert cand(1) == cand(16) == [16]
            assert cand(17) == cand(64) == [16, 64]
            assert cand(100) == cand(4096) == list(TMK.MMA_BM)
            assert TA._block_m_candidates(BERT_ATTN, 4096, phase, dtype, "cpu") == []
        narrow = lambda m: TA._block_m_candidates(SMOKE_ATTN, m, phase, "float32", "cuda")
        assert narrow(16) == narrow(64) == [64]
        assert narrow(100) == narrow(4096) == list(TMK.NARROW_BM)
        assert TA._block_m_candidates(SMOKE_ATTN, 4096, phase, "bfloat16", "cuda") == []
    assert TA._parse_label("kernel@128") == ("kernel", 128)
    assert TA._parse_label("reconstruct") == ("reconstruct", 0)


def test_forced_tiles_keep_the_rest_of_each_plan():
    """Each raced tile is a plan of its own: the tensor-core plan at that
    tile with its splits of I reckoned for it; ``csrc/mpo_linear.cu``'s
    with its row group, L group and resident stages chosen for it.  Tile 0
    is the plan the wrappers took before (unchanged); a tile the kernel is
    not built for, or whose shared memory does not fit, has no plan."""
    for m in (8, 48, 100, 2048):
        for dtype in ("bfloat16", "float32"):
            assert TMK.forward_plan(BERT_ATTN, m, dtype) == TMK._mma_plan(BERT_ATTN, m, dtype)
            for bm in TMK.MMA_BM:
                plan = TMK.forward_plan(BERT_ATTN, m, dtype, bm)
                assert plan.bm == bm
                assert plan.splits == TMK._mma_splits(768, 768, m, bm)
            assert TMK.forward_plan(BERT_ATTN, m, dtype, 32) is None
        assert TMK.forward_plan(SMOKE_ATTN, m, "float32") == TMK._narrow_plan(SMOKE_ATTN, m)
        for bm in TMK.NARROW_BM:
            assert TMK.forward_plan(SMOKE_ATTN, m, "float32", bm).bm == bm
        assert TMK.forward_plan(SMOKE_ATTN, m, "float32", 16) is None


def test_key_distinguishes_dtype_phase_and_substrate(monkeypatch):
    k = TA.make_key(SHAPES, TOKENS, "train", "float32")
    assert k != TA.make_key(SHAPES, TOKENS, "train", "bfloat16")
    assert k != TA.make_key(SHAPES, TOKENS, "prefill", "float32")
    assert k != TA.make_key(SHAPES, TOKENS + 1, "train", "float32")
    assert k.startswith("device=cpu|")
    # a card's verdicts name the card and its compute capability
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (9, 0))
    h100 = TA.make_key(SHAPES, TOKENS, "train", "float32", "cuda")
    assert h100 != k and "device=NVIDIA H100 80GB HBM3|cc=9.0|" in h100
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    assert TA.make_key(SHAPES, TOKENS, "train", "float32", "cuda") != h100


def test_key_names_the_torch_and_cuda_versions(tuned, monkeypatch):
    """A verdict measured under another torch or CUDA build never answers a
    lookup: the lookup misses, re-measures, and both entries stay."""
    k = TA.make_key(SHAPES, TOKENS, "prefill", "float32")
    assert f"|torch={torch.__version__}|cuda={torch.version.cuda}|" in k
    monkeypatch.setattr(torch.version, "cuda", "0.0-other")
    assert TA.make_key(SHAPES, TOKENS, "prefill", "float32") != k
    monkeypatch.setattr(torch, "__version__", "0.0.0-preupgrade")
    old = TA.make_key(SHAPES, TOKENS, "prefill", "float32")
    assert old != k
    _seed(tuned, old, "kernel", 64)
    monkeypatch.undo()
    monkeypatch.setenv(TA.ENV_CACHE, tuned)
    monkeypatch.setenv(TA.ENV_MEASURE, "1")
    tuner = _fresh()
    plan = TE.engine_for(CFG).plan(SHAPES, TOKENS, "prefill")
    assert plan.tuned and tuner.timing_runs > 0 and plan.mode != "kernel"
    entries = json.load(open(tuned))["entries"]
    assert old in entries and k in entries


def _cores(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES], \
        rng.standard_normal((TOKENS, 32)).astype(np.float32)


def test_disk_verdict_threads_into_plan_and_matches_the_reference(tuned, tmp_path,
                                                                  monkeypatch):
    """A disk verdict ``kernel@64`` becomes the plan ``("kernel", 64,
    tuned)`` with no timing and executes (the plain versions on the CPU):
    the same outputs and core gradients as the reference's engine given the
    same verdict in its own cache (its Pallas kernel, interpret mode)."""
    _seed(tuned, TA.make_key(SHAPES, TOKENS, "train", "float32"), "kernel", 64,
          {"kernel@64": 1e-6})
    tuner = _fresh()
    eng = TE.engine_for(CFG)
    plan = eng.plan(SHAPES, TOKENS, "train")
    assert (plan.mode, plan.block_m, plan.tuned, tuner.timing_runs) == ("kernel", 64, True, 0)

    cores_np, x_np = _cores()
    cores = [torch.from_numpy(c).requires_grad_() for c in cores_np]
    x = torch.from_numpy(x_np)
    calls = TMK.mpo_linear_plain.calls
    y = eng.linear({"cores": TL.cores_from_list(cores)}, x, phase="train")
    (y ** 2).sum().backward()
    assert TMK.mpo_linear_plain.calls > calls           # the kernel mode ran
    np.testing.assert_allclose(y.detach().numpy(), x_np @ TM.reconstruct(
        [torch.from_numpy(c) for c in cores_np]).numpy(), atol=1e-4)

    jpath = str(tmp_path / "reference.json")
    monkeypatch.setenv(JA.ENV_CACHE, jpath)
    monkeypatch.setenv(JA.ENV_MEASURE, "1")
    with open(jpath, "w") as f:
        json.dump({"version": JA.CACHE_VERSION, "entries": {
            JA.make_key(SHAPES, TOKENS, "train", "float32"): {
                "mode": "kernel", "block_m": 64, "timings": {"kernel@64": 1e-6}}}}, f)
    JE.clear_plan_cache()
    JA.reset_tuner()
    try:
        jeng = JE.MPOEngine(JL.MPOConfig(), interpret=True)
        jplan = jeng.plan(SHAPES, TOKENS, "train")
        assert (jplan.mode, jplan.block_m, jplan.tuned) == ("kernel", 64, True)
        jparams = {"cores": dict(zip(JL.core_names(3), map(jnp.asarray, cores_np)))}
        jx = jnp.asarray(x_np)
        jy = jeng.linear(jparams, jx, phase="train")
        jg = jax.grad(lambda p: jnp.sum(jeng.linear(p, jx, phase="train") ** 2))(jparams)
    finally:
        JE.clear_plan_cache()
        JA.reset_tuner()
    jy = np.asarray(jy)
    assert np.abs(y.detach().numpy() - jy).max() <= PARITY_TOL * np.abs(jy).max()
    for c, name in zip(cores, JL.core_names(3)):
        want = np.asarray(jg["cores"][name])
        assert np.abs(c.grad.numpy() - want).max() <= PARITY_TOL * np.abs(want).max(), name


# --------------------------------------------------------------------------
# the race, shared files, artifacts, sessions
# --------------------------------------------------------------------------


def test_race_picks_the_fastest_candidate(tuned):
    """Stub thunks through ``candidates_fn``: each runs once to warm up and
    three times timed, the verdict is the fastest and its tile, and the
    timings come back sorted."""
    build, calls = _stubs({"factorized": 0.03, "kernel@128": 0.0, "reconstruct": 0.015})
    tuner = TA.get_tuner()
    res = tuner.get(SHAPES, 4096, "prefill", "bfloat16", "cpu", candidates_fn=build)
    assert (res.mode, res.block_m, res.source) == ("kernel", 128, "measured")
    assert [k for k, _ in res.timings] == ["kernel@128", "reconstruct", "factorized"]
    assert calls == {k: TA.BENCH_WARMUP + TA.BENCH_REPS for k in calls}
    assert tuner.timing_runs == 3 and tuner.stats()["keys_resolved"] == 1
    assert tuner.get(SHAPES, 4096, "prefill", "bfloat16", "cpu") is res   # memory
    assert _fresh().get(SHAPES, 4096, "prefill", "bfloat16", "cpu").source == "disk"


def test_two_tuners_on_one_file_keep_each_others_keys(tuned):
    a, b = TA.Autotuner(tuned), TA.Autotuner(tuned)
    build, _ = _stubs({"factorized": 0.0, "reconstruct": 0.001})
    b._entries()                            # b read the file before a wrote
    a.get(SHAPES, 8, "prefill", "float32", "cpu", candidates_fn=build)
    b.get(SHAPES, 9, "prefill", "float32", "cpu", candidates_fn=build)
    entries = json.load(open(tuned))["entries"]
    assert {TA.make_key(SHAPES, t, "prefill", "float32") for t in (8, 9)} <= set(entries)


def test_export_import_local_wins_unless_overwrite(tuned, tmp_path):
    key = TA.make_key(SHAPES, TOKENS, "prefill", "float32")
    _seed(tuned, key, "factorized", 0)
    art = str(tmp_path / "ship" / "verdicts.json")
    assert TA.export_cache(art) == {"exported": 1, "path": art}
    _seed(art, key, "reconstruct", 0)                       # the fleet's verdict differs
    res = TA.import_cache(art)
    assert (res["imported"], res["skipped"], res["total"]) == (0, 1, 1)
    assert json.load(open(tuned))["entries"][key]["mode"] == "factorized"
    res = TA.import_cache(art, overwrite=True)
    assert (res["imported"], res["skipped"], res["total"]) == (1, 0, 1)
    assert json.load(open(tuned))["entries"][key]["mode"] == "reconstruct"
    assert _fresh().get(SHAPES, TOKENS, "prefill", "float32").mode == "reconstruct"
    other = str(tmp_path / "other.json")                    # a new key merges in
    _seed(other, TA.make_key(SHAPES, 4096, "prefill", "float32"), "kernel", 128)
    assert TA.import_cache(other)["total"] == 2


def test_artifacts_cross_the_packages_with_nothing_imported(tuned, tmp_path, monkeypatch):
    """Each package's artifact is its own cache format: the other's importer
    reads it without error and imports none of it (the keys could never
    match anyway: they name different substrates)."""
    jcache = str(tmp_path / "reference_cache.json")
    monkeypatch.setenv(JA.ENV_CACHE, jcache)
    JA.reset_tuner()
    try:
        with open(jcache, "w") as f:
            json.dump({"version": JA.CACHE_VERSION, "entries": {
                JA.make_key(SHAPES, TOKENS, "prefill", "float32"): {
                    "mode": "kernel", "block_m": 64, "timings": {}}}}, f)
        _seed(tuned, TA.make_key(SHAPES, TOKENS, "prefill", "float32"), "factorized", 0)
        jart, tart = str(tmp_path / "j.json"), str(tmp_path / "t.json")
        assert JA.export_cache(jart)["exported"] == 1
        assert TA.export_cache(tart)["exported"] == 1
        got = TA.import_cache(jart)
        assert (got["imported"], got["skipped"], got["total"]) == (0, 0, 1)
        got = JA.import_cache(tart)
        assert (got["imported"], got["skipped"], got["total"]) == (0, 0, 1)
        assert len(json.load(open(jcache))["entries"]) == 1
        assert len(json.load(open(tuned))["entries"]) == 1
    finally:
        JA.reset_tuner()


def test_races_inside_a_checkpointed_forward_run_once_a_key(tuned, monkeypatch):
    """Fine-tuning with remat plans inside ``torch.utils.checkpoint``: a
    ``train`` race there keeps its own saved tensors (the checkpoint's hooks
    would recompute the layer and re-enter planning), so each key is raced
    once and the step's losses equal the analytic run's."""
    import dataclasses
    from repro_torch import configs as tconfigs
    cfg = dataclasses.replace(tconfigs.smoke_config("bert-base"), remat=True, num_layers=2)
    raced = []
    build = TA._candidates
    monkeypatch.setattr(TA, "_candidates", lambda *a: raced.append(a) or build(*a))
    kw = dict(steps=1, seq_len=8, batch_size=2, seed=0)
    tuned_loss = TSession.init(cfg, device="cpu").finetune(**kw)["history"][0]["loss"]
    keys = [TA.make_key(*a) for a in raced]
    assert keys and len(keys) == len(set(keys)) == TA.get_tuner().stats()["keys_resolved"]
    assert all(a[2] == "train" for a in raced)
    monkeypatch.setenv(TA.ENV_MEASURE, "0")
    _fresh()
    assert TSession.init(cfg, device="cpu").finetune(**kw)["history"][0]["loss"] == \
        pytest.approx(tuned_loss, rel=1e-5)


def test_session_save_ships_verdicts_and_restore_resolves_them_warm(tuned, tmp_path,
                                                                    monkeypatch):
    """A smoke session's prefill planned by measurement: ``report()`` carries
    the tuner's stats, ``save`` writes ``autotune.json`` with the manifest's
    count, and a restore on a fresh cache and tuner imports it, so every key
    resolves again with no timing; local verdicts would win."""
    s = TSession.init("bert-base", device="cpu")
    assert "autotune" not in s.report()
    s.serve(2, 12, weight_cache=False).generate(
        {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8) % 50}, 2)
    rep = s.report()["autotune"]
    keys = json.load(open(tuned))["entries"]
    assert rep["keys_resolved"] == len(keys) > 0 and rep["timing_runs"] > 0
    d = s.save(str(tmp_path / "s"))
    manifest = json.load(open(os.path.join(d, "session.json")))
    shipped = json.load(open(os.path.join(d, "autotune.json")))["entries"]
    assert manifest["autotune_entries"] == len(shipped) == len(keys)

    monkeypatch.setenv(TA.ENV_CACHE, str(tmp_path / "fresh.json"))
    tuner = _fresh()
    r = TSession.restore(d, device="cpu")
    assert json.load(open(tmp_path / "fresh.json"))["entries"] == keys
    r.serve(2, 12, weight_cache=False).generate(
        {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8) % 50}, 2)
    assert tuner.timing_runs == 0 and tuner.stats()["keys_resolved"] == len(keys)
    assert r.report()["autotune"]["timing_runs"] == 0

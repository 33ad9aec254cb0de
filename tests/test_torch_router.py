"""The port's serving front end, part 3: the ``PoolRouter`` fleet
(``repro_torch.pipeline.router``) and ``Session.serve_fleet``.

The chaos matrix runs each scenario in both packages on the same requests
and the same fault plan — ``kill-pool`` mid-replay with a rebuild through
``Session.restore`` (the port's on ``device="cpu"``), ``trip-pool`` with its
canary, a NaN quarantine retried on the other replica that also trips a
one-event storm, retry exhaustion (the last ``FailReason``), ``shed-storm``
never touching a pool, and a replica dead without ``rebuild_fn`` — and
compares every request's status, error, attempts and tokens, and the
fleet's ``trips``, ``rebuilds``, ``retries`` and ``shed``.  Completed
requests also equal batch-1 serial generation.

The port's own policy for a kernel failure (the reference degrades flash to
a gather path instead; the port has no fallback): ``flash-raise`` makes a
lone pool raise ``InjectedKernelError``, and a fleet trips that replica as
crashed, fails its tenants over and still serves every request; the router
catches that and ``KernelLaunchError`` only.

Float32 smoke qwen3-14b, the same weights in both packages; prompts are
drawn until each serial token leads its runner-up by more than 1e-3 (a
near-tie would let float32 summation order pick the token)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.pipeline import router as jrouter
from repro.pipeline import traffic as jtraffic
from repro.resilience import faults as jfaults
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core.carry import load_jax_params
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.models import model as TModel
from repro_torch.pipeline import router as trouter
from repro_torch.pipeline import session as tsession
from repro_torch.pipeline import traffic
from repro_torch.resilience import faults

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "qwen3-14b"
MAX_LEN, PAGE = 32, 8
POOL_KW = dict(paged=True, page_size=PAGE)
ROUTER_KW = dict(breaker_cooldown_s=0.05, backoff_base_s=0.01)
GAP, BUDGET = 1e-3, 6
PACKAGES = {"ref": (jfaults, jrouter, jtraffic), "port": (faults, trouter, traffic)}


@pytest.fixture(scope="module")
def pair():
    """{"ref": reference Session, "port": port Session} over the same smoke
    weights."""
    src = TModel.build(tconfigs.smoke_config(ARCH), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    js = JSession(jconfigs.smoke_config(ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return {"ref": js, "port": ts}


def _greedy(handle, prompt, n):
    handle.reset()
    logits = handle.prefill({"tokens": prompt[None]})[0, -1]
    toks, leads = [], []
    for i in range(n):
        top = torch.topk(logits.float(), 2).values
        leads.append(float(top[0] - top[1]))
        toks.append(int(logits.argmax()))
        if i + 1 < n:
            logits = handle.decode(np.array([[toks[-1]]], np.int32))[1][0, -1]
    return np.asarray(toks, np.int32), leads


@pytest.fixture(scope="module")
def prompts(pair):
    """Three 5-token prompts (one prefill shape keeps the reference's jit
    cheap) and their serial tokens, each token leading by more than GAP."""
    handle = pair["port"].serve(1, MAX_LEN, **POOL_KW)
    rng = np.random.default_rng(11)
    out = []
    while len(out) < 3:
        p = rng.integers(1, 500, size=5).astype(np.int32)
        toks, leads = _greedy(handle, p, BUDGET)
        if min(leads) > GAP:
            np.testing.assert_array_equal(
                handle.generate({"tokens": p[None]}, BUDGET)[0].numpy(), toks)
            out.append((p, toks))
    return out


def _attempts(q) -> list:
    """A request's failed placements; the reference's storm detail names
    flash fallbacks too, which the port's storm does not count."""
    return [dict(a, detail=a["detail"].replace("quarantine/fallback events",
                                               "quarantine events")) for a in q.attempts]


def _outcome(router, rids) -> dict:
    """What the two packages must agree on."""
    st = router.stats()
    reqs = [router.request(r) for r in rids]
    return {
        "requests": [(q.status, None if q.error is None else str(q.error), q.error_detail,
                      q.output.tolist(), q.retries, _attempts(q)) for q in reqs],
        "fleet": {k: st[k] for k in ("trips", "rebuilds", "retries", "shed", "completed",
                                     "failed", "fail_reasons", "routed", "outstanding")},
        "states": [r["state"] for r in st["replicas"]],
        "pools_submitted": [None if r["pool"] is None else r["pool"]["submitted"]
                            for r in st["replicas"]],
    }


def _scenario(name, pkg, sess, prompts, tmp_path):
    """Run chaos scenario ``name`` in package ``pkg``; returns (router,
    rids, replay report or None)."""
    F, R, T = PACKAGES[pkg]
    ps = [p for p, _ in prompts]
    if name == "kill-pool":
        clock = T.VirtualClock(step_s=0.01)
        with F.fault_scope(F.FaultPlan(kill_pool=(1, 4))):
            router = sess.serve_fleet(3, 2, MAX_LEN, session_dir=str(tmp_path / pkg),
                                      clock=clock, router=ROUTER_KW, **POOL_KW)
            trace = [T.TrafficRequest(i * 0.005, p, BUDGET) for i, p in enumerate(ps * 3)]
            report = T.replay(router, trace, clock=clock, max_steps=4000)
        return router, [r["rid"] for r in report.records], report
    if name == "trip-pool":
        plan, n, kw = dict(trip_pool=0), 6, dict(router=ROUTER_KW)
    elif name == "nan-retry+storm":
        plan, n = dict(nan_decode_step=1, nan_decode_slot=0), 3
        kw = dict(router=dict(ROUTER_KW, storm_threshold=1))
    elif name == "retry-exhaustion":
        plan, n = dict(deny_page_admissions=10 ** 6), 1
        kw = dict(router=dict(retry_limit=1, backoff_base_s=0.0), admission_retry_limit=2)
    elif name == "shed-storm":
        plan, n, kw = dict(shed_storm=2), 8, dict(router=dict(shed_queue_depth=3, **ROUTER_KW))
    elif name == "dead-without-rebuild":
        pool = sess.serve_pool(2, MAX_LEN, **POOL_KW)
        with F.fault_scope(F.FaultPlan(kill_pool=(0, 0))):
            router = R.PoolRouter([pool], rebuild_fn=None)
            rid = router.submit(ps[0], BUDGET)
            router.run(max_steps=100)
        return router, [rid], None
    with F.fault_scope(F.FaultPlan(**plan)):
        router = sess.serve_fleet(2, 2, MAX_LEN, clock=T.VirtualClock(step_s=0.01), **kw,
                                  **POOL_KW)
        rids = [router.submit(p, BUDGET) for p in (ps * 3)[:n]]
        router.run(max_steps=4000)
    return router, rids, None


@pytest.mark.parametrize("name", ["kill-pool", "trip-pool", "nan-retry+storm",
                                  "retry-exhaustion", "shed-storm", "dead-without-rebuild"])
def test_chaos_matrix_equals_reference(pair, prompts, tmp_path, monkeypatch, name):
    restores = []
    restore = tsession.Session.restore.__func__

    def spy(cls, directory, *, device=None):
        restores.append(device)
        return restore(cls, directory, device=device)

    monkeypatch.setattr(tsession.Session, "restore", classmethod(spy))
    runs = {pkg: _scenario(name, pkg, pair[pkg], prompts, tmp_path) for pkg in PACKAGES}
    ours, ref = (_outcome(*runs[pkg][:2]) for pkg in ("port", "ref"))
    assert ours == ref
    if runs["port"][2] is not None:
        assert runs["port"][2].summary == runs["ref"][2].summary
    fleet, serial = ours["fleet"], [t for _, t in prompts]
    for i, (status, *_, toks, _, _) in enumerate(ours["requests"]):
        if status == "done":
            assert toks == serial[i % 3].tolist()
    router = runs["port"][0]
    if name == "kill-pool":
        assert fleet["trips"] == fleet["rebuilds"] == 1 and fleet["completed"] == 9
        assert ours["states"] == ["closed"] * 3
        # the replica was rebuilt from the saved session on the session's device
        assert restores == [torch.device("cpu")]
        assert router._replicas[1].pool.device.type == "cpu"
        moved = [q for q in ours["requests"] if q[5]]
        assert moved and all(a["reason"] == "replica" for q in moved for a in q[5])
    elif name == "trip-pool":
        assert fleet["trips"] == 1 and fleet["completed"] == 6
        assert ours["states"] == ["closed", "closed"]           # the canary passed
    elif name == "nan-retry+storm":
        assert fleet["completed"] == 3 and fleet["retries"] == 1 and fleet["trips"] == 1
        # the quarantined request retried elsewhere; the storm's trip moved the
        # other tenant of replica 0
        assert sorted(a["reason"] for q in ours["requests"] for a in q[5]) == \
            ["quarantine", "replica"]
    elif name == "retry-exhaustion":
        (status, error, detail, toks, retries, attempts), = ours["requests"]
        assert (status, error, retries) == ("failed", "admission", 1)
        assert "admission denied" in detail and [a["reason"] for a in attempts] == ["admission"]
    elif name == "shed-storm":
        assert fleet["shed"] == 5 and fleet["completed"] == 3
        assert fleet["fail_reasons"] == {"shed": 5} and sum(ours["pools_submitted"]) == 3
        for rep in router.stats()["replicas"]:
            assert rep["pool"]["page_pool"]["used"] == rep["pool"]["page_pool"]["reserved"] == 0
    elif name == "dead-without-rebuild":
        assert ours["states"] == ["dead"] and ours["pools_submitted"] == [None]
        assert ours["requests"][0][:2] == ("failed", "replica")


# --------------------------------------------------------------------------
# a kernel failure is a replica crash, not a fallback
# --------------------------------------------------------------------------


def test_flash_raise(pair, prompts, monkeypatch):
    """A lone pool's step raises ``InjectedKernelError`` from the flash
    wrapper, before dispatch.  In a fleet the replica stepping while the
    plan is active trips as crashed (its tenants fail over, it is rebuilt)
    and every request still ends with its serial tokens.  The plain
    version runs only as the CPU path of a flash call that got past the
    check — never in place of the kernel."""
    ts = pair["port"]
    calls = {"flash": 0, "raised": 0}
    wrapped = DA.flash_decode_attention

    def spy(*a, **k):
        calls["flash"] += 1
        try:
            return wrapped(*a, **k)
        except faults.InjectedKernelError:
            calls["raised"] += 1
            raise

    monkeypatch.setattr(DA, "flash_decode_attention", spy)
    plain0 = DA.flash_decode_attention_plain.calls
    (p0, t0), (p1, t1), (p2, t2) = prompts
    pool = ts.serve_pool(2, MAX_LEN, **POOL_KW)
    pool.submit(p0, BUDGET)
    with faults.fault_scope(faults.FaultPlan(flash_raises=True)):
        with pytest.raises(faults.InjectedKernelError, match="flash decode-attention"):
            pool.step()
    assert calls == {"flash": 1, "raised": 1}
    assert DA.flash_decode_attention_plain.calls == plain0

    router = ts.serve_fleet(2, 2, MAX_LEN, router=ROUTER_KW, **POOL_KW)
    rids = [router.submit(p0, BUDGET)]          # replica 0 alone has a tenant
    router.step()                               # admit + decode, fault-free
    with faults.fault_scope(faults.FaultPlan(flash_raises=True)):
        router.step()                           # replica 0's decode raises
    st = router.stats()
    assert st["trips"] == st["rebuilds"] == 1 and st["replicas"][0]["trips"] == 1
    req = router.request(rids[0])
    assert [a["reason"] for a in req.attempts] == ["replica"]
    assert "crashed: InjectedKernelError: injected flash" in req.attempts[0]["detail"]
    rids += [router.submit(p, BUDGET) for p in (p1, p2)]
    out = router.run(max_steps=4000)
    for rid, want in zip(rids, (t0, t1, t2)):
        np.testing.assert_array_equal(out[rid], want)
    # the plain version ran exactly once per flash call that was not refused
    assert DA.flash_decode_attention_plain.calls - plain0 == calls["flash"] - calls["raised"]
    assert calls["raised"] == 2


def test_router_catches_kernel_errors_only(pair, prompts):
    """A ``KernelLaunchError`` from a replica's step trips it with the
    error's text; any other exception propagates out of ``router.step``."""
    ts = pair["port"]
    (p0, t0), (p1, t1), _ = prompts
    router = ts.serve_fleet(2, 2, MAX_LEN, router=ROUTER_KW, **POOL_KW)
    rid = router.submit(p0, BUDGET)
    router.step()
    pool = router._replicas[0].pool

    def launch_error():
        raise KernelLaunchError("flash_decode_attention launch failed: CUDA error 700")

    pool.step = launch_error
    router.step()
    req = router.request(rid)
    assert router.stats()["trips"] == 1 and router._replicas[0].pool is not pool
    assert "crashed: KernelLaunchError: flash_decode_attention launch failed: CUDA error 700" \
        in req.attempts[0]["detail"]
    np.testing.assert_array_equal(router.run(max_steps=4000)[rid], t0)

    rid = router.submit(p1, BUDGET)
    router.step()
    busy = next(r for r in router._replicas if r.pool.live)

    def other():
        raise ValueError("not a kernel error")

    busy.pool.step = other
    with pytest.raises(ValueError, match="not a kernel error"):
        router.step()
    assert router.stats()["trips"] == 1

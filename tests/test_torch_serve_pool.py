"""The port's serving front end, part 1: chunked prefill and ``ServePool``
(``repro_torch.pipeline.scheduler``), held against the JAX package and
against the port's own serial ``ServeHandle.generate``.

The smoke qwen3-14b (2 layers, float32) carries the same weights into both
packages through ``core.carry.load_jax_params``.

- ``prefill_chunk`` chunk by chunk against the reference's on one tree,
  paged and dense: logits within 1e-5 (two frameworks' float32 sums; ~1e-6
  seen), ``page_table`` / ``free_list`` / ``free_count`` / ``pos``
  bit-equal.
- A pool's tokens equal batch-1 serial generation at the same ``max_len``
  and ``page_size`` (the reference's own invariant).  The pool decodes at
  batch ``slots``, the serial run at batch 1: their float32 sums may differ
  in the last bits, so every serial token is first shown to lead its
  runner-up by more than 1e-3 (``_generate``) — a flip then means a fault.
- Once in this file the pool is run in lockstep with the reference's
  ``ServePool`` on the same trace: tokens, ``fail_reasons``, ``page_pool``,
  ``prefill_traces`` and the page bookkeeping after every step bit-equal.
"""

import gc
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.models import transformer as JTR
from repro.resilience import faults as jfaults
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel
from repro_torch.models import transformer as TTR
from repro_torch.pipeline.clock import VirtualClock
from repro_torch.pipeline.scheduler import FailReason, ServePool
from repro_torch.resilience import faults

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "qwen3-14b"
MAX_LEN, PAGE = 32, 8
PAGED = dict(paged=True, page_size=PAGE)
GAP, LOGIT_TOL = 1e-3, 1e-5
DRAW_TOKENS = 10
SSM_MAX_LEN = 64
BOOKKEEPING = ("page_table", "free_list", "free_count", "pos")


@pytest.fixture(scope="module")
def pair():
    """(reference Session, port Session) over the same smoke weights."""
    src = TModel.build(tconfigs.smoke_config(ARCH), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    js = JSession(jconfigs.smoke_config(ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _leads(handle, prompt, n) -> list[float]:
    """The lead of each of the first ``n`` greedy tokens over its runner-up
    (batch-1 prefill and decode on ``handle``)."""
    handle.reset()
    logits = handle.prefill({"tokens": prompt[None]})[0, -1]
    out = []
    for i in range(n):
        top = torch.topk(logits.float(), 2).values
        out.append(float(top[0] - top[1]))
        if i + 1 < n:
            logits = handle.decode(logits.argmax().reshape(1, 1).to(torch.int32))[1][0, -1]
    return out


def _draw(handle, sizes, seed=0):
    """Prompts of these lengths from a seeded rng, each redrawn until its
    first ``DRAW_TOKENS`` greedy tokens lead their runners-up by more than
    ``GAP``: the random smoke weights put some top-2 logits within 1e-4,
    where float32 summation order would pick the token."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        while True:
            p = rng.integers(1, 500, size=n).astype(np.int32)
            if min(_leads(handle, p, min(DRAW_TOKENS, handle.max_len - n))) > GAP:
                break
        out.append(p)
    return out


def _generate(handle, prompt, n):
    """``handle.generate``'s greedy tokens for one prompt, each first shown
    to lead its runner-up by more than ``GAP``."""
    toks = handle.generate({"tokens": prompt[None]}, n)[0].numpy()
    leads = _leads(handle, prompt, n)
    assert min(leads) > GAP, f"near-tie: leads {leads}"
    return toks


@pytest.fixture(scope="module")
def draw(pair):
    """``draw(sizes, seed)``: ``_draw`` on the paged batch-1 handle."""
    handle = pair[1].serve(1, MAX_LEN, **PAGED)
    return lambda sizes, seed=0: _draw(handle, sizes, seed)


@pytest.fixture(scope="module")
def pool3(draw):
    return draw((5, 5, 5), seed=6)


@pytest.fixture(scope="module")
def serial(pair):
    """``serial(prompt, n, paged)``: batch-1 greedy tokens at the pools'
    ``max_len`` (and ``page_size`` when paged), memoized."""
    _, ts = pair
    handles, memo = {}, {}

    def run(prompt, n, paged=True):
        key = (prompt.tobytes(), n, paged)
        if key not in memo:
            if paged not in handles:
                handles[paged] = ts.serve(1, MAX_LEN, **(PAGED if paged else {}))
            memo[key] = _generate(handles[paged], prompt, n)
        return memo[key]

    return run


# --------------------------------------------------------------------------
# chunked prefill in the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(paged=True, page_size=4), {}], ids=["paged", "dense"])
def test_prefill_chunk_matches_reference(pair, kw):
    """Three chunks (5, 5, 3 tokens over pages of 4: each chunk starts in a
    half-filled page) at batch 2, chunk by chunk on one carried tree."""
    js, ts = pair
    prompts = np.random.default_rng(1).integers(1, 500, (2, 13)).astype(np.int32)
    jc = js.model.init_cache(2, MAX_LEN, **kw)
    tc = ts.model.init_cache(2, MAX_LEN, **kw)
    for a in range(0, 13, 5):
        piece = prompts[:, a:a + 5]
        jl, jc = js.model.prefill_chunk(js.params, {"tokens": jnp.asarray(piece)}, jc)
        with torch.no_grad():
            tl, tc = ts.model.prefill_chunk(ts.params, {"tokens": torch.from_numpy(piece)}, tc)
        assert tl.shape == jl.shape == (2, piece.shape[1], ts.cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for name in BOOKKEEPING:
            if name in tc:
                np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), name)
    assert int(tc["pos"][0, 0]) == 13


@pytest.mark.parametrize("kw", [dict(paged=True, page_size=4), {}], ids=["paged", "dense"])
def test_chunks_give_the_whole_prefill_tokens(pair, draw, kw):
    """The chunks in turn, then greedy decode, give one whole ``prefill``'s
    greedy tokens."""
    _, ts = pair
    [prompt] = draw((13,), seed=2)
    m, p = ts.model, ts.params
    toks = {}
    with torch.no_grad():
        for name in ("whole", "chunked"):
            cache = m.init_cache(1, MAX_LEN, **kw)
            if name == "whole":
                last = m.prefill(p, {"tokens": torch.from_numpy(prompt[None])}, cache)[0][:, -1]
            else:
                for a in range(0, 13, 4):
                    logits, cache = m.prefill_chunk(
                        p, {"tokens": torch.from_numpy(prompt[None, a:a + 4])}, cache)
                last = logits[:, -1]
            out = []
            for _ in range(6):
                tok = last.argmax(-1)[:, None].to(torch.int32)
                out.append(int(tok))
                last = m.decode_step(p, tok, cache)[0][:, -1]
            toks[name] = out
    assert toks["chunked"] == toks["whole"]


def test_init_cache_pool_pages_bounds(pair):
    _, ts = pair
    cfg = ts.cfg
    c = TTR.init_cache(cfg, 2, 32, paged=True, page_size=8, pool_pages=3)
    ref = JTR.init_cache(jconfigs.smoke_config(ARCH), 2, 32, paged=True, page_size=8,
                         pool_pages=3)
    for name in ref:
        assert tuple(c[name].shape) == ref[name].shape, name
    np.testing.assert_array_equal(c["free_list"].numpy(), np.asarray(ref["free_list"]))
    for bad in (0, 9):
        with pytest.raises(ValueError, match="pool_pages"):
            TTR.init_cache(cfg, 2, 32, paged=True, page_size=8, pool_pages=bad)


# --------------------------------------------------------------------------
# ServePool against serial generation
# --------------------------------------------------------------------------


MODES = {
    "whole": {},
    "whole-paged": PAGED,
    "bucket": dict(bucket_prompts=True),
    "chunk": dict(prefill_chunk=3),
    "chunk+bucket+paged": dict(prefill_chunk=4, bucket_prompts=True, **PAGED),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_pool_recycling_matches_serial(pair, serial, draw, mode):
    """6 requests of mixed prompt lengths and budgets through 2 slots: each
    tenant's tokens equal its batch-1 generation although slots were
    recycled mid-run and rows decoded at different offsets."""
    _, ts = pair
    kw = MODES[mode]
    prompts = draw((8, 5, 8, 11, 5, 8))
    budgets = [6, 9, 4, 7, 5, 8]
    pool = ts.serve_pool(2, MAX_LEN, **kw)
    rids = [pool.submit(p, n) for p, n in zip(prompts, budgets)]
    outs = pool.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], serial(prompts[i], budgets[i],
                                                        kw.get("paged", False)), f"request {i}")
    st = pool.stats()
    assert st["submitted"] == st["completed"] == 6 and st["failed"] == 0
    assert st["tokens_generated"] == sum(budgets)
    assert st["decode_tokens"] == sum(budgets) - 6
    assert st["prefill_tokens"] == sum(p.size for p in prompts)
    assert max(budgets) - 1 < st["decode_steps"] < sum(budgets)
    assert 0 < st["occupancy"] <= 1 and st["flash_fallbacks"] == 0
    assert not pool.admitting and pool.pending == 0 and pool.live == 0
    if kw.get("paged"):
        assert st["page_pool"]["used"] == 0 and st["page_pool"]["reserved"] == 0
    if kw.get("bucket_prompts") and not kw.get("prefill_chunk"):
        assert st["prefill_traces"] == 2           # lengths 5..11 -> buckets 8, 16


def test_pool_more_slots_than_requests(pair, serial, draw):
    _, ts = pair
    prompts = draw((6, 9), seed=1)
    pool = ts.serve_pool(4, MAX_LEN, **PAGED)
    rids = [pool.submit(p, 5) for p in prompts]
    outs = pool.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], serial(p, 5))
    assert pool.stats()["occupancy"] <= 0.5 + 1e-9  # 2 live of 4 slots


def test_pool_single_token_budget_never_occupies_slot(pair, serial, draw):
    _, ts = pair
    [p] = draw((5,), seed=3)
    pool = ts.serve_pool(1, MAX_LEN, **PAGED)
    rid = pool.submit(p, 1)
    outs = pool.run()
    np.testing.assert_array_equal(outs[rid], serial(p, 1))
    assert pool.stats()["decode_steps"] == 0 and pool.stats()["page_pool"]["used"] == 0


def test_pool_eos_frees_slot_early(pair, serial, draw):
    """A tenant that emits its EOS mid-budget stops there (the EOS token
    included) — its output is serial generation truncated at the EOS's
    first occurrence — and its one slot admits the next request."""
    _, ts = pair
    p, q = draw((8, 6), seed=4)
    full = serial(p, 10)
    eos = int(full[4])
    stop = int(np.nonzero(full == eos)[0][0])      # the EOS's first occurrence
    pool = ts.serve_pool(1, MAX_LEN, **PAGED)
    r1 = pool.submit(p, 10, eos_id=eos)
    r2 = pool.submit(q, 3)
    outs = pool.run()
    np.testing.assert_array_equal(outs[r1], full[:stop + 1])
    np.testing.assert_array_equal(outs[r2], serial(q, 3))
    st = pool.stats()
    assert st["completed"] == 2
    # r1 decoded only up to its EOS, then the slot served r2
    assert st["decode_steps"] == stop + 2


def test_pool_submit_and_knob_validation(pair):
    _, ts = pair
    pool = ts.serve_pool(1, 16)
    with pytest.raises(ValueError, match="exceeds the pool max_len"):
        pool.submit(np.zeros(10, np.int32), 10)
    with pytest.raises(ValueError, match="empty prompt"):
        pool.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError, match="max_new_tokens"):
        pool.submit(np.zeros(4, np.int32), 0)
    with pytest.raises(ValueError, match="deadline"):
        pool.submit(np.zeros(4, np.int32), 2, deadline_s=0)
    small = ts.serve_pool(2, MAX_LEN, pool_pages=2, **PAGED)
    with pytest.raises(ValueError, match="pages"):
        small.submit(np.arange(20, dtype=np.int32), 10)
    for kw, match in ((dict(pool_pages=4), "paged"), (dict(prefill_chunk=0), "prefill_chunk"),
                      (dict(bucket_min=0), "bucket_min"), (dict(slots=0), "slots")):
        kw = dict(dict(slots=2), **kw)
        with pytest.raises(ValueError, match=match):
            ts.serve_pool(kw.pop("slots"), MAX_LEN, **kw)
    # families: vlm, hybrid and encdec cannot pool (the reference's refusal)
    for family, match in (("vlm", "ServePool supports"), ("hybrid", "ServePool supports"),
                          ("encdec", "ServePool supports")):
        stub = types.SimpleNamespace(cfg=types.SimpleNamespace(family=family))
        with pytest.raises(NotImplementedError, match=match):
            ServePool(stub, {}, 2, MAX_LEN)
    # a pool on a mesh needs the logical-axis tree (tests/test_torch_mesh.py
    # runs pools on meshes)
    standin = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    with pytest.raises(ValueError, match="axes="):
        ServePool(ts.model, ts.params, 2, MAX_LEN, mesh=standin)


def test_pool_incremental_stepping_and_late_submit(pair, serial, draw):
    """A request submitted AFTER the pool started decoding is admitted into
    the recycled slot; step() drives one batched decode at a time."""
    _, ts = pair
    prompts = draw((6, 8), seed=5)
    pool = ts.serve_pool(1, MAX_LEN, **PAGED)
    r1 = pool.submit(prompts[0], 4)
    assert pool.step() == 1 and pool.step() == 1
    r2 = pool.submit(prompts[1], 3)              # while r1 is live
    assert pool.pending == 1 and pool.live == 1
    outs = pool.run()
    np.testing.assert_array_equal(outs[r1], serial(prompts[0], 4))
    np.testing.assert_array_equal(outs[r2], serial(prompts[1], 3))


# --------------------------------------------------------------------------
# degradation: backpressure, quarantine, deadlines, budgets
# --------------------------------------------------------------------------


def test_oversubscribed_pool_backpressures(pair, serial, pool3):
    """3 pages hold ONE worst-case request (ceil(10/8) = 2 pages): admission
    queues instead of underflowing the free list; injected denials retry,
    then past the retry limit fail the request alone."""
    _, ts = pair
    pool = ts.serve_pool(2, MAX_LEN, pool_pages=3, **PAGED)
    rids = [pool.submit(p, 6) for p in pool3]
    out = pool.run()
    st = pool.stats()
    assert st["failed"] == 0 and st["page_pool"]["pages"] == 3
    assert st["page_pool"]["reserved"] == 0 and st["page_pool"]["used"] == 0
    assert st["occupancy"] <= 0.5 + 1e-9          # never two tenants at once
    assert sum(pool.request(r).admit_denials for r in rids) > 0
    for rid, p in zip(rids, pool3):
        np.testing.assert_array_equal(out[rid], serial(p, 6))
    with faults.fault_scope(faults.FaultPlan(deny_page_admissions=2)):
        pool = ts.serve_pool(2, MAX_LEN, **PAGED)
        rids = [pool.submit(p, 6) for p in pool3]
        out = pool.run()
    assert pool.stats()["failed"] == 0 and pool.request(rids[0]).admit_denials == 2
    for rid, p in zip(rids, pool3):
        np.testing.assert_array_equal(out[rid], serial(p, 6))
    with faults.fault_scope(faults.FaultPlan(deny_page_admissions=10 ** 6)):
        pool = ts.serve_pool(2, MAX_LEN, admission_retry_limit=3, **PAGED)
        rid = pool.submit(pool3[0], 6)
        assert pool.run() == {}
    req = pool.request(rid)
    assert req.status == "failed" and req.error is FailReason.ADMISSION
    assert "admission denied 4 times" in req.error_detail


def test_nan_quarantine_spares_healthy_slots(pair, serial, pool3):
    _, ts = pair
    with faults.fault_scope(faults.FaultPlan(nan_decode_step=1, nan_decode_slot=0)):
        pool = ts.serve_pool(2, MAX_LEN, **PAGED)
        rids = [pool.submit(p, 6) for p in pool3]
        out = pool.run()
    st = pool.stats()
    assert st["failed"] == 1 and st["fail_reasons"] == {"quarantine": 1}
    bad = st["failures"][0]
    assert bad["slot"] == 0 and bad["reason"] == "quarantine" and "non-finite" in bad["detail"]
    req = pool.request(bad["rid"])
    assert req.status == "failed" and not req.done and bad["rid"] not in out
    # no token appended at the poisoned step: a prefix of the serial tokens
    np.testing.assert_array_equal(req.output, serial(pool3[bad["rid"]], 6)[:len(req.tokens)])
    for rid, p in zip(rids, pool3):
        if rid != bad["rid"]:
            np.testing.assert_array_equal(out[rid], serial(p, 6))
    assert st["page_pool"]["used"] == 0 and st["page_pool"]["reserved"] == 0


def test_deadlines_and_budget_on_a_virtual_clock(pair, serial, pool3):
    """Expiry on a VirtualClock is exact: a queued request past its deadline
    fails before admission; a live one fails with a serial prefix; a pool
    budget fails what is left."""
    _, ts = pair
    pool = ts.serve_pool(1, MAX_LEN, clock=VirtualClock(step_s=1.0), **PAGED)
    ok = pool.submit(pool3[0], 4)
    dead = pool.submit(pool3[1], 4, deadline_s=2.5)
    out = pool.run()
    assert ok in out and dead not in out
    assert pool.stats()["failures"] == [{"rid": dead, "slot": None, "reason": "deadline",
                                         "detail": "deadline (2.5s) expired before admission"}]
    pool = ts.serve_pool(1, MAX_LEN, clock=VirtualClock(step_s=1.0), **PAGED)
    live = pool.submit(pool3[2], 8, deadline_s=3.5)
    assert pool.run() == {}
    req = pool.request(live)
    # admitted at t=0 with its first token, one more a step; the deadline
    # check at the top of the step at t=4 > 3.5 finds 5 tokens
    assert req.error is FailReason.DEADLINE and req.error_detail.endswith("after 5 tokens")
    np.testing.assert_array_equal(req.output, serial(pool3[2], 8)[:5])
    assert pool.stats()["page_pool"]["used"] == 0
    pool = ts.serve_pool(1, MAX_LEN, clock=VirtualClock(step_s=1.0), **PAGED)
    rids = [pool.submit(p, 6) for p in pool3]
    out = pool.run(budget_s=6.5)
    assert list(out) == [rids[0]]
    assert pool.stats()["fail_reasons"] == {"budget": 2}
    assert pool.stats()["page_pool"]["used"] == 0


def test_expire_admit_chunk_leaves_nothing_behind(pair, serial, draw, pool3):
    """An admission abandoned between prefill chunks (``expire-admit:2``)
    drops its half-built batch-1 cache before anything was adopted: the pool
    keeps no page of it, and the next admissions, on the same rewound
    batch-1 cache, give serial tokens."""
    _, ts = pair
    [long_prompt] = draw((16,), seed=8)
    with faults.fault_scope(faults.FaultPlan(expire_admit_chunk=2)):
        pool = ts.serve_pool(2, MAX_LEN, prefill_chunk=2, **PAGED)
        victim = pool.submit(long_prompt, 4, deadline_s=120.0)
        rids = [pool.submit(p, 6) for p in pool3]
        out = pool.run()
    req = pool.request(victim)
    assert req.status == "failed" and req.error is FailReason.DEADLINE
    assert "prefill chunks (2/8)" in req.error_detail and req.tokens == []
    for rid, p in zip(rids, pool3):
        np.testing.assert_array_equal(out[rid], serial(p, 6))
    st = pool.stats()
    assert st["page_pool"]["used"] == 0 and st["page_pool"]["reserved"] == 0
    again = pool.submit(long_prompt, 4)
    np.testing.assert_array_equal(pool.run()[again], serial(long_prompt, 4))


def test_ssm_prefill_takes_any_length():
    """A prompt longer than a chunk and not a whole number of chunks (37
    tokens, chunks of 16; the reference asserts whole chunks) is padded with
    dt = 0 steps: its logits and final state are the reference's with one
    chunk of 37 (rel. 1e-4: two frameworks' float32 sums, in other chunks)."""
    src = TModel.build(tconfigs.smoke_config("mamba2-130m"), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    jm = JSession(jconfigs.smoke_config("mamba2-130m", ssm_chunk=37),
                  jax.tree.map(jnp.asarray, tree)).model
    assert src.cfg.ssm_chunk == 16
    tokens = np.random.default_rng(3).integers(1, 500, (2, 37)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jstate = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jm.init_cache(2, 64))
    with torch.no_grad():
        tl, tstate = src.prefill(src.tree(), {"tokens": torch.from_numpy(tokens)},
                                 src.init_cache(2, 64))
    for ours, ref in ((tl, jl), (tstate, jstate)):
        ref = np.asarray(ref, np.float32)
        err = np.abs(ours.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, err


def test_ssm_pool_matches_serial():
    """Position-free SSM states recycle per slot too, prompts longer than a
    chunk included; the ssm family has no KV cache to page or prefill in
    chunks."""
    ts = TSession.init("mamba2-130m", device="cpu")
    h1 = ts.serve(1, SSM_MAX_LEN)
    prompts = _draw(h1, (7, 4, 37, 21), seed=4)
    want = [_generate(h1, p, 5) for p in prompts]
    pool = ts.serve_pool(2, SSM_MAX_LEN)
    rids = [pool.submit(p, 5) for p in prompts]
    outs = pool.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(outs[rid], w)
    assert pool.stats()["page_pool"] is None
    with pytest.raises(ValueError, match="paged KV cache requires"):
        ts.serve_pool(2, SSM_MAX_LEN, paged=True)
    for kw in (dict(prefill_chunk=4), dict(bucket_prompts=True)):
        with pytest.raises(ValueError, match="incremental KV prefill"):
            ts.serve_pool(2, SSM_MAX_LEN, **kw)


# --------------------------------------------------------------------------
# against the reference's ServePool, step by step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(pool_pages=5), dict(prefill_chunk=3, bucket_prompts=True)],
                         ids=["whole+oversubscribed", "chunk+bucket"])
def test_pool_matches_the_reference_pool(pair, draw, kw):
    """Both packages' pools on one trace, stepped in turn, each under its
    own package's NaN plan: after every step (each admission and each free)
    the page bookkeeping is bit-equal; at the end the tokens, statuses,
    ``fail_reasons``, ``page_pool`` and ``prefill_traces``."""
    js, ts = pair
    kw = dict(kw, **PAGED)
    prompts = draw((8, 5, 12, 3, 9, 6, 5), seed=9)
    budgets = [6, 3, 5, 1, 7, 4, 2]
    plan = dict(nan_decode_step=3, nan_decode_slot=0)
    pools = {"ref": js.serve_pool(3, MAX_LEN, **kw), "port": ts.serve_pool(3, MAX_LEN, **kw)}
    with jfaults.fault_scope(jfaults.FaultPlan(**plan)), \
            faults.fault_scope(faults.FaultPlan(**plan)):
        for p, n in zip(prompts[:4], budgets[:4]):
            assert pools["ref"].submit(p, n) == pools["port"].submit(p, n)
        for i in range(200):
            if i == 2:                          # late arrivals
                for p, n in zip(prompts[4:], budgets[4:]):
                    pools["ref"].submit(p, n)
                    pools["port"].submit(p, n)
            adv = {k: pool.step() for k, pool in pools.items()}
            assert adv["ref"] == adv["port"], i
            for name in BOOKKEEPING:
                np.testing.assert_array_equal(pools["port"]._cache[name].numpy(),
                                              np.asarray(pools["ref"]._cache[name]),
                                              f"{name} after step {i}")
            if adv["port"] == 0 and not pools["port"].pending and not pools["port"].admitting:
                break
    for rid in range(len(prompts)):
        r, t = pools["ref"].request(rid), pools["port"].request(rid)
        assert (t.status, t.error, t.error_detail) == (r.status, r.error, r.error_detail)
        np.testing.assert_array_equal(t.output, r.output, f"request {rid}")
    st = {k: pool.stats() for k, pool in pools.items()}
    for key in ("fail_reasons", "page_pool", "prefill_traces", "failures", "completed",
                "tokens_generated", "decode_steps", "occupancy", "prefill_tokens",
                "decode_tokens"):
        assert st["port"][key] == st["ref"][key], key
    assert st["port"]["fail_reasons"] == {"quarantine": 1}
    assert set(st["port"]) == set(st["ref"])


# --------------------------------------------------------------------------
# report()["serve_pools"]: pools held weakly
# --------------------------------------------------------------------------


def test_report_holds_pools_weakly(pair, draw):
    """``report()`` lists the stats of pools the caller still holds.  A
    dropped pool is freed by its reference count alone — the collector is
    off while it is dropped, so nothing here depends on when it runs — and
    leaves the report."""
    _, ts = pair
    [p] = draw((5,), seed=7)
    pool = ts.serve_pool(1, MAX_LEN, **PAGED)
    pool.submit(p, 2)
    pool.run()
    rep = ts.report()
    st = rep["serve_pools"][-1]
    assert {"slots", "occupancy", "tok_per_s", "completed"} <= set(st)
    assert st["completed"] == 1
    n_live = len(rep["serve_pools"])
    ref = weakref.ref(pool)
    gc.disable()
    try:
        del pool, rep, st
        assert ref() is None, gc.get_referrers(ref())
        assert len(ts.report().get("serve_pools", [])) == n_live - 1
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# the moe family in a pool
# --------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_MODES = {"whole": {}, "chunk": dict(prefill_chunk=3),
             "chunk+bucket": dict(prefill_chunk=4, bucket_prompts=True)}


@pytest.fixture(scope="module")
def moe_pair():
    """(reference Session, port Session) over the same smoke phi3.5-moe
    weights (2 layers, 4 experts, top-2)."""
    src = TModel.build(tconfigs.smoke_config(MOE_ARCH), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    js = JSession(jconfigs.smoke_config(MOE_ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(MOE_ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


@pytest.mark.parametrize("mode", list(MOE_MODES))
def test_moe_pool_matches_the_reference_pool(moe_pair, mode):
    """MoE pools of 2 slots, paged, in both packages on one trace: the same
    tokens for every request.  The expert capacity depends on the admitted
    sequence's length, and chunked and bucketed admission route the padding
    too, as the reference does; whole-prompt admission (batch 1, the
    prompt's length) routes as serial generation, so there the tokens also
    equal batch-1 ``generate`` (each serial token leading its runner-up by
    more than ``GAP``)."""
    js, ts = moe_pair
    kw = dict(MOE_MODES[mode], **PAGED)
    handle = ts.serve(1, MAX_LEN, **PAGED)
    prompts = _draw(handle, (8, 5, 11, 6), seed=4)
    budgets = [6, 4, 7, 5]
    pools = {"ref": js.serve_pool(2, MAX_LEN, **kw), "port": ts.serve_pool(2, MAX_LEN, **kw)}
    rids = {k: [pool.submit(p, n) for p, n in zip(prompts, budgets)]
            for k, pool in pools.items()}
    outs = {k: pool.run() for k, pool in pools.items()}
    for i in range(len(prompts)):
        ref = np.asarray(outs["ref"][rids["ref"][i]])
        np.testing.assert_array_equal(outs["port"][rids["port"][i]], ref, f"request {i}")
        if mode == "whole":
            np.testing.assert_array_equal(ref, _generate(handle, prompts[i], budgets[i]),
                                          f"request {i} against serial generation")
    assert pools["port"].stats()["completed"] == len(prompts)

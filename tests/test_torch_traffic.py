"""The port's serving front end, part 2: open-loop traffic
(``repro_torch.pipeline.traffic``), continuous admission under load, and
the ``serve-replay`` command.

- ``make_trace`` gives the reference's trace for the same arguments, byte
  for byte (numpy only, the same draws in the same order).
- ``replay`` of one trace through both packages' pools on a
  ``VirtualClock``: the summary and every record equal.
- Under load, every completion equals batch-1 serial generation truncated
  at its budget or EOS, and the paged pool leaks no page.

Float32 smoke qwen3-14b, the same weights in both packages through
``core.carry.load_jax_params``.  A near-tie would let two float32 summation
orders pick different tokens, so every serial token is first shown to lead
its runner-up by more than 1e-3 (the prompts of the combo grid are drawn
until they do; a trace is taken from the first seed from 0 up whose
requests all do)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.pipeline import traffic as jtraffic
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel
from repro_torch.pipeline import cli, traffic
from repro_torch.pipeline.clock import VirtualClock

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "qwen3-14b"
MAX_LEN, PAGE = 32, 8
PAGED = dict(paged=True, page_size=PAGE)
GAP = 1e-3
VOCAB = 50          # small vocab so EOS ids fire mid-stream
SERIAL_TOKENS = 8


@pytest.fixture(scope="module")
def pair():
    """(reference Session, port Session) over the same smoke weights."""
    src = TModel.build(tconfigs.smoke_config(ARCH), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    js = JSession(jconfigs.smoke_config(ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _greedy(handle, prompt, n):
    """Batch-1 greedy tokens and each one's lead over its runner-up."""
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
def serial(pair):
    """``serial(prompt, n)``: ``ServeHandle.generate``'s batch-1 tokens at
    the pools' ``max_len`` and ``page_size``, each shown to lead by GAP."""
    handle = pair[1].serve(1, MAX_LEN, **PAGED)
    memo = {}

    def run(prompt, n):
        key = (prompt.tobytes(), n)
        if key not in memo:
            toks, leads = _greedy(handle, prompt, n)
            assert min(leads) > GAP, f"near-tie: leads {leads}"
            np.testing.assert_array_equal(
                handle.generate({"tokens": prompt[None]}, n)[0].numpy(), toks)
            memo[key] = toks
        return memo[key]

    return run


def _expected(full, budget, eos_id):
    """Serial tokens truncated at the budget, then at the EOS."""
    toks = full[:budget]
    if eos_id is not None:
        hits = np.nonzero(toks == eos_id)[0]
        if hits.size:
            toks = toks[:hits[0] + 1]
    return toks


# --------------------------------------------------------------------------
# traces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n=50, rate_rps=25.0, seed=9),
    dict(n=20, rate_rps=4.0, seed=0, prompt_len=(64, 512), max_new=(8, 16), vocab_size=50432),
    dict(n=32, rate_rps=8.0, seed=3, prompt_len=(16, 128), max_new=(8, 32), vocab_size=30720,
         eos_id=2, deadline_s=1.5),
], ids=["defaults", "mamba2-130m", "bert-base+eos+deadline"])
def test_make_trace_equals_reference(kw):
    n, rate = kw.pop("n"), kw.pop("rate_rps")
    ours, ref = traffic.make_trace(n, rate, **kw), jtraffic.make_trace(n, rate, **kw)
    assert len(ours) == len(ref) == n
    assert np.asarray([r.at_s for r in ours]).tobytes() == \
        np.asarray([r.at_s for r in ref]).tobytes()
    for a, b in zip(ours, ref):
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert a.prompt.tobytes() == b.prompt.tobytes()
        assert (a.max_new_tokens, a.eos_id, a.deadline_s) == (b.max_new_tokens, b.eos_id,
                                                                b.deadline_s)
    assert all(x.at_s < y.at_s for x, y in zip(ours, ours[1:]))
    with pytest.raises(ValueError, match="n=0"):
        traffic.make_trace(0, 1.0)
    with pytest.raises(ValueError, match="rate_rps"):
        traffic.make_trace(1, 0.0)


def _clear_trace(handle, **kw):
    """``make_trace(**kw)`` at the first seed from 0 up whose every request
    leads by GAP over its budget on ``handle``."""
    for seed in range(100):
        trace = traffic.make_trace(seed=seed, **kw)
        if all(min(_greedy(handle, r.prompt, r.max_new_tokens)[1]) > GAP for r in trace):
            return trace
    raise AssertionError("no tie-free trace in 100 seeds")


@pytest.mark.parametrize("kw", [PAGED, dict(prefill_chunk=4, bucket_prompts=True, **PAGED)],
                         ids=["whole+paged", "chunk+bucket+paged"])
def test_replay_equals_reference(pair, serial, kw):
    """One open-loop trace (bursty: 40 rps into 2 slots) through both
    packages' pools on a VirtualClock: the same summary and records."""
    js, ts = pair
    trace = _clear_trace(ts.serve(1, MAX_LEN, **PAGED), n=10, rate_rps=40.0,
                         prompt_len=(3, 12), max_new=(1, 8), vocab_size=500)
    reports = {}
    for name, sess, mod in (("ref", js, jtraffic), ("port", ts, traffic)):
        clock = mod.VirtualClock(step_s=0.01)
        pool = sess.serve_pool(2, MAX_LEN, clock=clock, **kw)
        reports[name] = mod.replay(pool, trace, clock=clock, max_steps=2000)
    ours, ref = reports["port"], reports["ref"]
    assert ours.summary == ref.summary
    assert ours.summary["completed"] == len(trace) and ours.summary["p99_latency_s"] > 0
    for a, b, req in zip(ours.records, ref.records, trace):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["tokens"], serial(req.prompt, req.max_new_tokens))
        assert {k: v for k, v in a.items() if k != "tokens"} == \
            {k: v for k, v in b.items() if k != "tokens"}


# --------------------------------------------------------------------------
# continuous admission under load (the port alone, against serial)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def grid(pair):
    """Prompt length -> (prompt, its serial tokens): one tie-free prompt per
    length of the combo grid."""
    handle = pair[1].serve(1, MAX_LEN, **PAGED)
    out = {}
    for plen in (3, 5, 8, 13, 16):
        rng = np.random.default_rng(1000 + plen)
        while True:
            p = rng.integers(1, VOCAB, size=plen).astype(np.int32)
            toks, leads = _greedy(handle, p, SERIAL_TOKENS)
            if min(leads) > GAP:
                out[plen] = (p, toks)
                break
    return out


def _combo_trace(grid, n, rate_rps, rng):
    """``n`` Poisson arrivals from the combo grid (prompt length x budget x
    EOS x deadline); the EOS ids are tokens the grid's serial runs emit, so
    they fire mid-stream; the deadlines never expire."""
    plens, budgets = sorted(grid), (1, 2, 4, 8)
    eoses = sorted({int(t) for _, toks in grid.values() for t in toks[1:4]})[:3]
    at = np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
    out = []
    for i in range(n):
        plen = int(rng.choice(plens))
        eos = [None, *eoses][int(rng.integers(len(eoses) + 1))]
        out.append(traffic.TrafficRequest(float(at[i]), grid[plen][0],
                                          int(rng.choice(budgets)), eos,
                                          120.0 if rng.integers(2) else None))
    return out


@pytest.mark.parametrize("kw", [
    dict(bucket_prompts=True),
    dict(prefill_chunk=4),
    dict(prefill_chunk=4, bucket_prompts=True, **PAGED),
], ids=["bucket", "chunk", "chunk+bucket+paged"])
def test_traffic_stress_parity_and_page_accounting(pair, grid, kw):
    """60 open-loop arrivals per admission mode: every completion equals
    serial generation truncated at its budget or EOS, no page leaks."""
    _, ts = pair
    n = 60
    trace = _combo_trace(grid, n, 200.0, np.random.default_rng(sum(map(ord, str(kw)))))
    pool = ts.serve_pool(4, MAX_LEN, **kw)
    report = traffic.replay(pool, trace, clock=VirtualClock(step_s=0.005),
                            max_steps=400 * n)
    assert report.summary["completed"] == n and report.summary["failed"] == 0
    for req, rec in zip(trace, report.records):
        want = _expected(grid[req.prompt.size][1], req.max_new_tokens, req.eos_id)
        np.testing.assert_array_equal(rec["tokens"], want, f"rid {rec['rid']}")
    assert any(req.eos_id is not None and rec["tokens"].size < req.max_new_tokens
               for req, rec in zip(trace, report.records)), "no EOS fired"
    st = pool.stats()
    assert not pool.admitting and pool.pending == 0 and pool.live == 0
    if st["page_pool"] is not None:
        assert st["page_pool"]["used"] == 0 and st["page_pool"]["reserved"] == 0
    assert st["prefill_toks_s"] > 0 and st["decode_toks_s"] > 0
    assert st["prefill_tokens"] == sum(r.prompt.size for r in trace)
    # each request's FIRST token comes from the admission prefill
    assert st["decode_tokens"] == st["tokens_generated"] - n


def test_bucketed_admission_bounds_prefill_shapes(pair, grid):
    """14 distinct prompt lengths: bucketing keeps the distinct prefill
    lengths within log2(max_len); without it there is one per length."""
    _, ts = pair
    lengths = list(range(3, 17))
    prompts = [np.resize(grid[16][0], n) for n in lengths]
    bucketed = ts.serve_pool(2, MAX_LEN, bucket_prompts=True)
    whole = ts.serve_pool(2, MAX_LEN)
    for pool in (bucketed, whole):
        for p in prompts:
            pool.submit(p, 2)
        pool.run()
    assert bucketed.stats()["prefill_traces"] <= 5 == int(np.log2(MAX_LEN))
    assert whole.stats()["prefill_traces"] == len(lengths)
    for rid in range(len(lengths)):
        np.testing.assert_array_equal(bucketed.request(rid).output, whole.request(rid).output)


def test_chunked_admission_interleaves_with_decode(pair, grid):
    """While a 16-token prompt streams in 2-token chunks, the live tenant
    gains a token every step."""
    _, ts = pair
    pool = ts.serve_pool(2, MAX_LEN, prefill_chunk=2, **PAGED)
    r1 = pool.submit(grid[3][0], 8)
    pool.step()
    assert pool.request(r1).status == "live"
    r2 = pool.submit(grid[16][0], 4)             # 8 chunks of 2
    interleaved = 0
    while pool.admitting or pool.pending:
        before = len(pool.request(r1).tokens)
        pool.step()
        if pool.admitting and len(pool.request(r1).tokens) > before:
            interleaved += 1
    assert interleaved >= 6
    pool.run()
    np.testing.assert_array_equal(pool.request(r1).output, grid[3][1][:8])
    np.testing.assert_array_equal(pool.request(r2).output, grid[16][1][:4])


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------


def test_cli_serve_replay_on_the_cpu(capsys):
    assert cli.main(["serve-replay", "--device", "cpu", "--requests", "8", "--rate", "50"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu"
    assert out["summary"]["requests"] == out["summary"]["completed"] == 8
    assert out["summary"]["tok_s"] > 0 and 0 < out["occupancy"] <= 1
    assert cli.main(["serve-replay", "--device", "cpu", "--requests", "6", "--rate", "50",
                     "--replicas", "2", "--paged", "--page-size", "8", "--chunk", "4",
                     "--virtual-clock", "--chaos", "kill-pool:1:3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["summary"]["completed"] == 6
    assert out["router"]["trips"] == out["router"]["rebuilds"] == 1


def test_cli_lifecycle_and_tune_commands(tmp_path, capsys, monkeypatch):
    args = ["--device", "cpu", "--steps", "2", "--tokens", "3",
            "--session-dir", str(tmp_path / "s")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["stage"] == "serve" and report["weights_version"] == 1
    assert cli.main(args) == 0                    # restored, not trained again
    assert "restored session" in capsys.readouterr().out
    # the tuner's verdicts shipped and merged back (a cache of the test's own)
    from repro_torch.kernels import autotune
    cache = tmp_path / "cache.json"
    autotune._write_cache(str(cache), {"k": {"mode": "factorized", "block_m": 0,
                                             "timings": {}}})
    monkeypatch.setenv(autotune.ENV_CACHE, str(cache))
    autotune.reset_tuner()
    assert cli.main(["tune-export", str(tmp_path / "t.json")]) == 0
    assert "[tune-export] 1 verdicts" in capsys.readouterr().out
    assert cli.main(["tune-import", str(tmp_path / "t.json")]) == 0
    assert "[tune-import] 0 imported, 1 skipped" in capsys.readouterr().out
    assert cli.main(["tune-import", str(tmp_path / "t.json"), "--overwrite"]) == 0
    assert "[tune-import] 1 imported, 0 skipped" in capsys.readouterr().out
    autotune.reset_tuner()

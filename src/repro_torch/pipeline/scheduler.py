"""Multi-tenant batched decode — the port of ``repro.pipeline.scheduler``:
``ServePool`` packs independent generation requests into a fixed
``(slots, max_len)`` decode batch.

The serving substrate (``make_serve_steps`` + the per-slot-position KV cache
of ``transformer.init_cache``) decodes a whole batch in one step, each row
at its OWN offset.  ``ServePool`` is the scheduler on top:

* ``submit()`` enqueues a request (prompt + token budget + optional EOS);
* admission prefills the prompt on the pool's batch-1 cache and copies the
  resulting KV rows (and per-slot position) into a free slot of the pool
  cache — live tenants' rows are untouched, so admitting tenant B never
  re-prefills tenant A;
* every ``step()`` runs ONE batched decode over all slots; finished rows
  (budget exhausted or EOS emitted) free their slot, which the next
  admission recycles;
* ``stats()`` reports slot occupancy and aggregate tokens/s —
  ``Session.report()`` surfaces it for every pool the session created.

Continuous admission (``prefill_chunk=`` / ``bucket_prompts=``) streams the
admission prefill instead of running it whole:

* ``bucket_prompts=True`` right-pads each prompt to a power-of-two length
  bucket before prefill (causal masking makes real positions independent of
  the padding), bounding the distinct prefill shapes at ~``log2(max_len)``;
* ``prefill_chunk=N`` feeds the (padded) prompt through the incremental
  chunk prefill N tokens at a time, ONE chunk per ``step()`` while tenants
  are live — a long prompt's admission interleaves with decode instead of
  stalling every live tenant for its full prefill.

Both give the whole-prompt path's tokens and compose with paged KV:
bucket-padding pages never reach the pool (adoption copies only the real
context).

The caches are updated in place (the reference's are immutable arrays).
The pool owns ONE batch-1 admission cache and rewinds it
(``Model.reset_cache``) at the start of every admission, so an admission
abandoned mid-stream (deadline, the ``expire-admit`` chaos site) leaves
nothing the next one sees, and never touched the pool cache.  Adoption and
recycling pop and push each layer's free-list stack as the reference's
per-layer ``vmap`` does — page ids, ``free_list`` and ``free_count`` come
out bit-equal to the reference's — with the tenant's length taken from the
host (the prompt length), never read back from the device.  A decode step
moves the greedy tokens and the per-slot finiteness vector to the host in
ONE transfer; the logits stay on the device.

Graceful degradation: a bad request fails ALONE; healthy tenants keep their
slots and their tokens.

* page-reservation admission — each request reserves its worst-case page
  count up front, so an oversubscribed pool (``pool_pages=``) backpressures
  at admission (bounded FIFO retry, then a per-request failure) instead of
  underflowing the free list mid-decode;
* a NaN/inf logit guard quarantines only the offending slot (fail + free
  the pages, no token appended) — the other slots' tokens are unchanged;
* per-request deadlines (``submit(deadline_s=)``) and a pool clock budget
  (``run(budget_s=)``) expire stragglers as failures.

A kernel failure is not degraded: the flash kernel has no fallback, so a
``KernelLaunchError`` (or the ``flash-raise`` chaos site's
``InjectedKernelError``) propagates out of ``step()``; a ``PoolRouter``
fleet counts it as that replica's crash.  ``stats()["flash_fallbacks"]`` is
kept for the reference's keys and is always 0.

Failures are reported per request: ``request(rid).status == "failed"`` with
a stable ``.error`` code (``FailReason`` — the router's retry/trip policy
keys on it) and the human-readable ``.error_detail``, and aggregated in
``stats()["failures"]`` (a bounded ring of recent entries; the per-reason
counters in ``stats()["fail_reasons"]`` stay exact).

Time comes from an injectable clock (``pipeline.clock``): deadlines,
budgets and ``submitted_at`` all read ``clock.now()``, so tests pin expiry
behaviour on a ``VirtualClock`` instead of sleeping.

Example::

    pool = session.serve_pool(slots=4, max_len=64)
    for p in prompts:                       # independent tenants
        pool.submit(p, max_new_tokens=16)
    outputs = pool.run()                    # {rid: np.ndarray of token ids}
    print(pool.stats()["tok_per_s"])
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
import time

import numpy as np
import torch

from repro_torch.parallel import spmd
from repro_torch.pipeline.clock import WallClock
from repro_torch.resilience import faults
from repro_torch.train.steps import make_serve_steps

# families whose decode step tolerates per-slot state: transformers carry
# per-slot positions in the KV cache; SSM states are position-free.  The
# hybrid and encdec caches hold one shared position per segment or layer,
# and the vlm and encdec frontends need more than a token prompt at
# admission (the reference's refusals, kept).
SUPPORTED_FAMILIES = ("dense", "moe", "ssm")

# recent-failure ring size (aggregate counters stay exact past the cap)
FAILURE_LOG_CAP = 512


class FailReason(str, enum.Enum):
    """Stable failure-reason codes carried in ``Request.error`` and
    ``stats()["failures"]``.  Policy code (router retries, breaker trips)
    keys on THESE values, never on message text.  A ``str`` mixin so
    substring checks and JSON serialization keep working."""

    DEADLINE = "deadline"        # per-request deadline_s expired
    QUARANTINE = "quarantine"    # NaN/inf logits; slot quarantined
    ADMISSION = "admission"      # page backpressure retries exhausted
    BUDGET = "budget"            # pool run(budget_s=) exhausted
    SHED = "shed"                # load-shed at the router front door
    REPLICA = "replica"          # serving replica died/tripped under it

    def __str__(self) -> str:    # "deadline", not "FailReason.DEADLINE"
        return self.value


@dataclasses.dataclass
class Request:
    """One tenant's generation request, tracked by the pool.

    ``tokens`` accumulates the generated ids (the first comes from the
    admission prefill, the rest from batched decode steps).  ``status``
    walks ``queued -> live -> done`` — or ``-> failed``, with the stable
    reason code in ``error`` and the explanation in ``error_detail``.
    ``done`` is the "completed successfully" flag (failed requests are
    terminal but NOT done)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None = None
    deadline_s: float | None = None
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "queued"         # queued | admitting | live | done | failed
    error: FailReason | None = None
    error_detail: str | None = None
    slot: int | None = None
    submitted_at: float = 0.0      # pool clock.now() at submit
    admit_denials: int = 0         # backpressure retries so far
    pages_reserved: int = 0        # worst-case pages held while admitted

    @property
    def output(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)


class ServePool:
    """Fixed-slot multi-tenant decode scheduler over one weight snapshot.

    Built once per serving session (``Session.serve_pool``): runs
    ``init_serve`` ONCE, for the pool batch (weight-cache contraction, a
    clone of the leaves it passes through, the pool cache).  Admission runs
    on the same snapshot over a batch-1 cache from
    ``model.init_cache(1, max_len, ...)`` — no second contraction, no second
    clone.  A pool built before a ``finetune``/``squeeze`` keeps serving the
    OLD weights; build a new pool after mutating the session.  With
    ``mesh=`` the snapshot, the pool cache and the batch-1 admission cache
    are placed by the rules (``make_serve_steps(mesh=)``; a moe layer's
    experts over ``model``), and an admission writes its rows into the
    placed cache, each rank its own block.
    """

    def __init__(self, model, params, slots: int, max_len: int, *,
                 weight_cache: bool = True, mesh=None, rules=None, axes=None,
                 version: int = 0,
                 paged: bool = False, page_size: int = 16,
                 pool_pages: int | None = None, admission_retry_limit: int = 1000,
                 guard_logits: bool = True, prefill_chunk: int | None = None,
                 bucket_prompts: bool = False, bucket_min: int = 8, clock=None):
        family = model.cfg.family
        if family not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"ServePool supports families {SUPPORTED_FAMILIES}; "
                f"{family!r} decode still tracks one shared position per cache "
                "segment (or needs a non-token frontend at admission), so slots "
                "cannot sit at independent offsets")
        if paged and family == "ssm":
            raise ValueError("paged KV cache requires an attention KV "
                             "cache; family 'ssm' has none")
        if slots < 1:
            raise ValueError(f"slots={slots} must be >= 1")
        if pool_pages is not None and not paged:
            raise ValueError("pool_pages= requires paged=True")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be >= 1 (or None to "
                "disable chunked admission)")
        if bucket_min < 1:
            raise ValueError(f"bucket_min={bucket_min} must be >= 1")
        if ((prefill_chunk is not None or bucket_prompts)
                and model.prefill_chunk is None):
            raise ValueError(
                "chunked/bucketed admission needs an incremental KV prefill "
                f"(model.prefill_chunk); family {family!r} has "
                "none — use the default whole-prompt admission")
        self.slots, self.max_len = slots, max_len
        self.version = version
        self.paged, self.page_size = paged, page_size
        self.admission_retry_limit = admission_retry_limit
        self.guard_logits = guard_logits
        self.prefill_chunk = prefill_chunk
        self.bucket_prompts, self.bucket_min = bucket_prompts, bucket_min
        # all deadline/budget arithmetic reads this clock (tests pass a
        # VirtualClock; share ONE instance with the router/replay loop)
        self.clock = WallClock() if clock is None else clock
        # continuous admission: prompts stream through the chunked-prefill
        # step (one chunk per decode step while tenants are live)
        self._continuous = prefill_chunk is not None or bucket_prompts
        self.device = model.device
        self.mesh = mesh
        t0 = time.perf_counter()
        self._prefill1, self._decode, init_pool, self._chunk1 = make_serve_steps(
            model, weight_cache=weight_cache, mesh=mesh, rules=rules, axes=axes,
            paged=paged, page_size=page_size, pool_pages=pool_pages)
        with torch.no_grad():
            self._sparams, self._cache = init_pool(params, slots, max_len)
            if paged:
                # park every slot at the capacity sentinel: idle rows neither
                # write pages nor allocate from the shared pool until a
                # tenant is adopted into them
                self._local(self._cache)["pos"].fill_(self._capacity())
            cache_kw = {"paged": True, "page_size": page_size} if paged else {}
            self._cache1 = model.init_cache(1, max_len, **cache_kw)
            if mesh is not None:
                # the admission cache on the mesh by the pool's rules
                from repro_torch.parallel import sharding as S
                rules1 = S.head_safe_rules(S.make_rules(mesh) if rules is None else rules,
                                           model.cfg, mesh)
                self._cache1 = S.place_tree(
                    self._cache1, S.cache_sharding(self._cache1, mesh, rules1), mesh)
        self._model_reset = model.reset_cache
        self._sync()
        self.init_seconds = time.perf_counter() - t0
        self._requests: dict[int, Request] = {}
        self._queue: collections.deque[int] = collections.deque()
        self._slot_rid: list[int | None] = [None] * slots
        self._last_tok = np.zeros((slots, 1), np.int32)
        self._next_rid = 0
        # in-flight chunked admission (continuous mode): at most one prompt
        # streams through the batch-1 chunk prefill at a time, one chunk per
        # step while tenants are live.  The target slot is NOT in
        # ``_slot_rid`` until the last chunk lands (decode skips it).
        self._admit_state: dict | None = None
        # page-reservation admission state (paged pools only)
        self._total_pages = int(self._cache["k_pages"].shape[1]) if paged else 0
        self._reserved_pages = 0
        # ---- stats ----
        self._decode_steps = 0
        self._live_slot_steps = 0       # sum of live slots over decode steps
        self._tokens_generated = 0
        self._prefill_tokens = 0        # prompt tokens prefilled (real, unpadded)
        self._decode_tokens = 0         # tokens produced by batched decode
        self._prefill_shapes: set[int] = set()  # distinct prefill seq lengths
        self._completed = 0
        self._failed = 0
        # recent failures only (long replays must not grow without bound);
        # _fail_reasons keeps the exact per-reason totals forever
        self._failure_cap = int(os.environ.get("REPRO_FAILURE_LOG_CAP",
                                               FAILURE_LOG_CAP))
        self._failures: collections.deque[dict] = collections.deque(
            maxlen=self._failure_cap)
        self._fail_reasons: collections.Counter = collections.Counter()
        self._decode_seconds = 0.0
        self._admit_seconds = 0.0

    def _local(self, cache):
        """The cache as the host bookkeeping touches it: on a mesh every
        leaf's local block (``parallel.spmd.cache_views``; the integer
        leaves are replicated, so each rank holds them whole)."""
        return cache if self.mesh is None else spmd.cache_views(cache, all_leaves=True)

    def _reset_cache(self, cache):
        self._model_reset(self._local(cache))
        return cache

    def _sync(self):
        """Wait for the card, so a host clock read after it times the work
        (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capacity(self) -> int:
        """The parked-slot position sentinel: the page capacity of a row."""
        return self._cache["page_table"].shape[-1] * self._cache["k_pages"].shape[2]

    # ---- admission: the batch-1 cache into a pool slot ----

    def _adopt(self, cache1, slot: int, n: int):
        """Copy the batch-1 tenant cache (context length ``n``) into pool
        slot ``slot``."""
        if self.paged:
            self._adopt_paged(cache1, slot, n)
            return
        if isinstance(self._cache, dict):
            pairs = [(self._cache[k], cache1[k]) for k in self._cache]
        else:                                        # the ssm state tensor
            pairs = [(self._cache, cache1)]
        for pc, oc in pairs:                         # every leaf is (layers, batch, ...)
            # on a mesh: the rank that owns the slot's row copies its block
            # (the batch-1 cache's other dims are split as the pool's)
            lo, hi = spmd.local_range(pc, 1)
            if lo <= slot < hi:
                spmd.local(pc)[:, slot - lo].copy_(spmd.local(oc)[:, 0])

    def _adopt_paged(self, cache1, slot: int, n: int):
        """Pop one pool page per tenant page in use off each layer's free-list
        stack, copy the page data, and point the slot's table row at the new
        physical pages (the reference's ``_adopt_paged_fn``).  Every layer
        holds ``ceil(n / page_size)`` tenant pages, a prefix of its row."""
        c, cache1 = self._local(self._cache), self._local(cache1)
        used = -(-n // self.page_size)
        layers = c["pos"].shape[0]
        lidx = torch.arange(layers, device=self.device)[:, None]
        rank = torch.arange(used, device=self.device)[None, :]
        pids = c["free_list"].gather(1, (c["free_count"][:, None] - 1 - rank).long())
        src = cache1["page_table"][:, 0, :used].clamp(min=0).long()
        c["k_pages"][lidx, pids.long()] = cache1["k_pages"][lidx, src]
        c["v_pages"][lidx, pids.long()] = cache1["v_pages"][lidx, src]
        c["page_table"][:, slot, :used] = pids
        c["page_table"][:, slot, used:] = -1
        c["pos"][:, slot] = n
        c["free_count"].sub_(used)

    def _free_slot(self, slot: int):
        """Recycle slot ``slot`` of a paged pool: push its mapped pages back
        onto each layer's free list in table order, clear the table row, park
        the position at the sentinel (the reference's ``_free_slot_fn``).
        No host sync: the pushed entries are placed by a gather."""
        c = self._local(self._cache)
        fl, fc = c["free_list"], c["free_count"]
        row = c["page_table"][:, slot]               # (layers, MP) view
        valid = row >= 0
        count = valid.sum(1)                         # (layers,)
        # the valid entries first, in table order
        packed = row.gather(1, torch.argsort((~valid).int(), dim=1, stable=True))
        off = torch.arange(fl.shape[1], device=self.device)[None, :] - fc[:, None]
        push = (off >= 0) & (off < count[:, None])
        fl.copy_(torch.where(push, packed.gather(
            1, off.clamp(0, row.shape[1] - 1).long()), fl))
        row.fill_(-1)
        c["pos"][:, slot] = self._capacity()
        fc.add_(count.to(fc.dtype))

    def _need_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page count a request can ever occupy: the prefill
        appends ``prompt_len`` keys, each decode step one more, and the
        LAST generated token never appends (its key is never attended)."""
        if not self.paged:
            return 0
        return -(-(prompt_len + max_new - 1) // self.page_size)

    def validate_request(self, prompt, max_new_tokens: int,
                         deadline_s: float | None = None) -> np.ndarray:
        """Reject requests that can NEVER be served — prompt + budget over
        ``max_len`` or over the whole physical page pool — up front; returns
        the normalized (1-D int32) prompt.  Shared by ``submit`` and the
        fleet router, which validates before enqueueing."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens} must be >= 1")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size} tokens) + max_new_tokens "
                f"({max_new_tokens}) exceeds the pool max_len "
                f"({self.max_len}); raise max_len or shorten the request")
        need = self._need_pages(prompt.size, max_new_tokens)
        if need > self._total_pages:
            raise ValueError(
                f"request needs {need} KV pages (prompt {prompt.size} + "
                f"max_new_tokens {max_new_tokens} at page_size "
                f"{self.page_size}) but the physical pool only holds "
                f"{self._total_pages}; raise pool_pages or shorten the "
                f"request")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} must be positive")
        return prompt

    def submit(self, prompt, max_new_tokens: int, eos_id: int | None = None,
               deadline_s: float | None = None) -> int:
        """Enqueue one generation request; returns its request id.  Admission
        happens at the next ``step()``/``run()`` when a slot is free.
        ``deadline_s`` bounds the request's whole lifetime on the pool's
        clock (queue wait included)."""
        prompt = self.validate_request(prompt, max_new_tokens, deadline_s)
        rid = self._next_rid
        self._next_rid += 1
        self._requests[rid] = Request(rid, prompt, max_new_tokens, eos_id,
                                      deadline_s=deadline_s,
                                      submitted_at=self.clock.now())
        self._queue.append(rid)
        return rid

    def request(self, rid: int) -> Request:
        """The tracked request (status/error/tokens) for ``rid``."""
        return self._requests[rid]

    def _finish(self, req: Request):
        req.done = True
        req.status = "done"
        self._release_reservation(req)
        self._completed += 1

    def _fail(self, req: Request, reason: FailReason, detail: str):
        """Terminal per-request failure: the pool keeps serving everyone
        else; the partial output stays on the request."""
        req.status = "failed"
        req.error = reason
        req.error_detail = detail
        self._release_reservation(req)
        self._failed += 1
        self._fail_reasons[reason.value] += 1
        self._failures.append({"rid": req.rid, "slot": req.slot,
                               "reason": reason.value, "detail": detail})

    def _release_reservation(self, req: Request):
        self._reserved_pages -= req.pages_reserved
        req.pages_reserved = 0

    def _release_slot(self, slot: int):
        """Free pool slot ``slot`` (pages back to the pool for paged
        caches); the next admission recycles it."""
        self._slot_rid[slot] = None
        if self.paged:
            self._free_slot(slot)

    def _expired(self, req: Request) -> bool:
        return (req.deadline_s is not None
                and self.clock.now() - req.submitted_at > req.deadline_s)

    def _expire(self):
        """Fail queued and live requests past their deadline."""
        if any(self._requests[r].deadline_s is not None
               for r in self._queue) or any(
                   r is not None and self._requests[r].deadline_s is not None
                   for r in self._slot_rid):
            keep = collections.deque()
            for rid in self._queue:
                req = self._requests[rid]
                if self._expired(req):
                    self._fail(req, FailReason.DEADLINE,
                               f"deadline ({req.deadline_s}s) expired "
                               "before admission")
                else:
                    keep.append(rid)
            self._queue = keep
            for slot, rid in enumerate(self._slot_rid):
                if rid is None:
                    continue
                req = self._requests[rid]
                if self._expired(req):
                    self._fail(req, FailReason.DEADLINE,
                               f"deadline ({req.deadline_s}s) expired "
                               f"after {len(req.tokens)} tokens")
                    self._release_slot(slot)
        st = self._admit_state
        if st is not None and self._expired(st["req"]):
            # in-flight chunked admission: abandon the half-built batch-1
            # cache; nothing was adopted, so the pool is untouched
            self._admit_state = None
            self._fail(st["req"], FailReason.DEADLINE,
                       f"deadline ({st['req'].deadline_s}s) "
                       "expired between prefill chunks "
                       f"({st['next']}/{len(st['pieces'])})")

    def _admit_one(self, slot: int, req: Request):
        """Prefill the prompt at batch 1 and copy its cache rows into
        ``slot``.  The prefill's last-position logits give the tenant's
        FIRST generated token (as ``ServeHandle.generate``)."""
        t0 = time.perf_counter()
        req.slot = slot
        self._prefill_shapes.add(int(req.prompt.size))
        cache1 = self._reset_cache(self._cache1)
        tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
        logits, cache1 = self._prefill1(self._sparams, {"tokens": tokens}, cache1)
        first = int(torch.argmax(logits[0, -1]))
        self._complete_admission(req, slot, first, cache1)
        self._sync()
        self._admit_seconds += time.perf_counter() - t0

    def _complete_admission(self, req: Request, slot: int, first: int, cache1):
        """Emit the first token; adopt the tenant into ``slot`` unless it
        finished instantly (one-token budget or first-token EOS)."""
        req.tokens.append(first)
        self._tokens_generated += 1
        self._prefill_tokens += int(req.prompt.size)
        if req.max_new_tokens == 1 or first == req.eos_id:
            self._finish(req)       # never occupies the slot
            return
        req.status = "live"
        self._slot_rid[slot] = req.rid
        self._last_tok[slot, 0] = first
        self._adopt(cache1, slot, int(req.prompt.size))

    # ---- continuous admission (chunked / length-bucketed prefill) ----

    def _bucket_len(self, n: int) -> int:
        """Padded prefill length for an ``n``-token prompt: next power of
        two, floored at ``bucket_min``, capped at ``max_len``."""
        if not self.bucket_prompts:
            return n
        return min(max(self.bucket_min, 1 << (n - 1).bit_length()),
                   self.max_len)

    def _pieces(self, prompt: np.ndarray) -> list[np.ndarray]:
        """Split the (bucket-padded) prompt into prefill chunks.  Padding
        token ids are irrelevant (never attended by real positions, and
        their KV is overwritten before decode attends it): zeros."""
        padded_len = self._bucket_len(prompt.size)
        if padded_len != prompt.size:
            prompt = np.concatenate(
                [prompt, np.zeros(padded_len - prompt.size, np.int32)])
        c = self.prefill_chunk
        if c is None or c >= padded_len:
            return [prompt]
        return [prompt[i:i + c] for i in range(0, padded_len, c)]

    def _admit_start(self, slot: int, req: Request):
        """Begin a (possibly multi-step) chunked admission into ``slot``, on
        the rewound batch-1 cache."""
        req.slot = slot
        req.status = "admitting"
        self._admit_state = {"req": req, "slot": slot,
                             "cache": self._reset_cache(self._cache1),
                             "pieces": self._pieces(req.prompt),
                             "next": 0, "off": 0, "first": None}

    def _admit_piece(self):
        """Run ONE prefill chunk of the in-flight admission; complete the
        admission (first token + pool adoption) after the last chunk."""
        st = self._admit_state
        req = st["req"]
        if st["next"] > 0 and (faults.admit_chunk_expired(st["next"])
                               or self._expired(req)):
            # deadline blew between chunks: the half-built batch-1 cache is
            # abandoned (the next admission rewinds it) — nothing was
            # adopted, the pool page table and the slot are untouched
            self._admit_state = None
            self._fail(req, FailReason.DEADLINE,
                       f"deadline ({req.deadline_s}s) expired between "
                       f"prefill chunks ({st['next']}/{len(st['pieces'])})")
            return
        t0 = time.perf_counter()
        piece = st["pieces"][st["next"]]
        self._prefill_shapes.add(int(piece.size))
        tokens = torch.from_numpy(piece[None, :]).to(self.device)
        logits, st["cache"] = self._chunk1(self._sparams, {"tokens": tokens}, st["cache"])
        # the REAL last prompt token's logits row picks the first generated
        # token — under bucket padding that row is inside some chunk, not
        # necessarily the last position of the last chunk
        last = int(req.prompt.size) - 1
        if st["off"] <= last < st["off"] + piece.size:
            st["first"] = int(torch.argmax(logits[0, last - st["off"]]))
        st["off"] += int(piece.size)
        st["next"] += 1
        if st["next"] >= len(st["pieces"]):
            self._admit_state = None
            # pin the batch-1 position from the padded length back to the
            # real prompt length: adoption then copies only the real context
            # (paged: only ceil(real/ps) pages — padding pages never reach
            # the pool), and decode overwrites the padded KV at position
            # ``real_len`` before anything attends it
            self._local(st["cache"])["pos"].fill_(int(req.prompt.size))
            self._complete_admission(req, st["slot"], st["first"], st["cache"])
        self._sync()
        self._admit_seconds += time.perf_counter() - t0

    def _admission_blocked(self, req: Request) -> bool:
        """Page backpressure: deny admission while the head request's
        worst-case reservation does not fit the unreserved remainder of the
        pool.  Head-of-line blocking is deliberate (FIFO fairness) and safe:
        ``submit`` already rejected anything that can never fit, so the head
        clears as live tenants finish and release their reservations."""
        if not self.paged:
            return False
        need = self._need_pages(req.prompt.size, req.max_new_tokens)
        denied = (self._reserved_pages + need > self._total_pages
                  or faults.page_admission_denied())
        if denied:
            req.admit_denials += 1
        else:
            req.pages_reserved = need
            self._reserved_pages += need
        return denied

    def _deny_head(self, req: Request) -> bool:
        """The head request was denied pages: fail it once its retries are
        spent (True: the queue moved), else leave it queued (False)."""
        if req.admit_denials <= self.admission_retry_limit:
            return False
        self._queue.popleft()
        self._fail(req, FailReason.ADMISSION,
                   f"page-pool admission denied {req.admit_denials} times "
                   f"(admission_retry_limit={self.admission_retry_limit})")
        return True

    def _free_slot_for_admission(self) -> int | None:
        """A slot no live tenant (and no in-flight admission) holds."""
        held = (self._admit_state["slot"]
                if self._admit_state is not None else None)
        for slot in range(self.slots):
            if self._slot_rid[slot] is None and slot != held:
                return slot
        return None

    def _admit(self):
        if self._continuous:
            self._admit_continuous()
            return
        # keep scanning: an admission that finishes instantly (one-token
        # budget / first-token EOS) leaves its slot free for the next
        # pending request in the SAME pass
        progressed = True
        while self._queue and progressed:
            progressed = False
            for slot in range(self.slots):
                if not self._queue:
                    return
                if self._slot_rid[slot] is not None:
                    continue
                req = self._requests[self._queue[0]]
                if self._admission_blocked(req):
                    progressed = self._deny_head(req)
                    break           # else: the head stays queued; a later step retries
                self._queue.popleft()
                self._admit_one(slot, req)
                progressed = True

    def _admit_continuous(self):
        """Continuous-mode admission: while tenants are live, run at most
        ONE prefill chunk per step (decode interleaves between chunks, so a
        long prompt never stalls the pool); with nobody live there is
        nothing to stall, so drain chunks back to back."""
        while True:
            if self._admit_state is not None:
                self._admit_piece()
            elif self._queue:
                slot = self._free_slot_for_admission()
                if slot is None:
                    return
                req = self._requests[self._queue[0]]
                if self._admission_blocked(req):
                    if self._deny_head(req):
                        continue    # head failed: try the next request
                    return          # head stays queued; a later step retries
                self._queue.popleft()
                self._admit_start(slot, req)
                self._admit_piece()
            else:
                return
            if self.live > 0:
                return              # decode is waiting: one chunk per step

    # ---- decode ----

    @property
    def live(self) -> int:
        """Currently occupied slots."""
        return sum(r is not None for r in self._slot_rid)

    @property
    def pending(self) -> int:
        """Submitted but not yet admitted requests."""
        return len(self._queue)

    @property
    def admitting(self) -> bool:
        """A chunked admission is in flight (continuous mode only)."""
        return self._admit_state is not None

    @property
    def free_pages(self) -> int | None:
        """Unreserved KV pages (host-side reservation accounting — no
        device sync), ``None`` for dense pools.  The router's least-loaded
        policy reads this."""
        if not self.paged:
            return None
        return self._total_pages - self._reserved_pages

    @torch.no_grad()
    def step(self) -> int:
        """Expire deadline-blown requests, admit whatever fits, then run ONE
        batched decode step over all slots.  Returns the number of live
        slots that advanced (0 means the pool is drained).

        NaN/inf quarantine (``guard_logits``): a live slot whose logits row
        went non-finite fails ALONE — no token is appended for it, its slot
        and pages are freed, and every healthy slot's argmax is taken from
        the logits it would see in a fault-free run.  A kernel error
        propagates."""
        self._expire()
        self._admit()
        if self.live == 0:
            return 0
        t0 = time.perf_counter()
        tokens = torch.from_numpy(self._last_tok).to(self.device)
        tok, logits, self._cache = self._decode(self._sparams, tokens, self._cache)
        # chaos: NaN-poison one slot's logits at the chosen decode step
        # (host-side copy — device values and healthy slots are untouched)
        corrupted = faults.corrupt_decode_logits(logits, self._decode_steps)
        if corrupted is not None:
            finite = np.isfinite(corrupted).all(axis=tuple(range(1, corrupted.ndim)))
            tok_host = np.argmax(corrupted[:, -1], axis=-1).astype(np.int32)
        elif self.guard_logits:
            # the tokens and the per-slot finiteness vector in one transfer
            ok = torch.isfinite(logits).flatten(1).all(1).to(torch.int32)
            host = torch.stack([tok[:, 0], ok], 1).cpu().numpy()
            tok_host, finite = host[:, 0], host[:, 1].astype(bool)
        else:
            tok_host, finite = tok[:, 0].cpu().numpy(), None
        self._decode_seconds += time.perf_counter() - t0
        self._decode_steps += 1
        advanced = 0
        for slot, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            advanced += 1
            req = self._requests[rid]
            if finite is not None and not finite[slot]:
                self._fail(req, FailReason.QUARANTINE,
                           "non-finite logits at decode step "
                           f"{self._decode_steps - 1} (slot {slot} "
                           "quarantined)")
                self._release_slot(slot)
                continue            # no token appended for the bad slot
            t = int(tok_host[slot])
            req.tokens.append(t)
            self._tokens_generated += 1
            self._decode_tokens += 1
            self._last_tok[slot, 0] = t
            if len(req.tokens) >= req.max_new_tokens or t == req.eos_id:
                self._finish(req)
                self._release_slot(slot)  # recycled at next admission
        self._live_slot_steps += advanced
        return advanced

    def run(self, budget_s: float | None = None) -> dict[int, np.ndarray]:
        """Drain the pool: step until every submitted request completed (or
        failed).  Returns {rid: generated token ids} for ALL successfully
        finished requests; failures are on ``request(rid)`` / ``stats()``.

        ``budget_s`` bounds the WHOLE drain's clock time (the injected
        ``clock``): past it, every still-queued/live request fails with its
        partial output and the call returns what completed in time."""
        t0 = self.clock.now()
        while (self._queue or self.live > 0
               or self._admit_state is not None):
            if budget_s is not None and self.clock.now() - t0 > budget_s:
                for rid in list(self._queue):
                    self._fail(self._requests[rid], FailReason.BUDGET,
                               f"pool wall-clock budget ({budget_s}s) "
                               "exhausted before admission")
                self._queue.clear()
                if self._admit_state is not None:
                    st, self._admit_state = self._admit_state, None
                    self._fail(st["req"], FailReason.BUDGET,
                               "pool wall-clock budget "
                               f"({budget_s}s) exhausted between prefill "
                               f"chunks ({st['next']}/{len(st['pieces'])})")
                for slot, rid in enumerate(self._slot_rid):
                    if rid is not None:
                        req = self._requests[rid]
                        self._fail(req, FailReason.BUDGET,
                                   "pool wall-clock budget "
                                   f"({budget_s}s) exhausted after "
                                   f"{len(req.tokens)} tokens")
                        self._release_slot(slot)
                break
            advanced = self.step()
            self.clock.on_step(advanced)   # no-op on WallClock
            if (advanced == 0 and not self._queue
                    and self._admit_state is None):
                break
        return {rid: r.output for rid, r in self._requests.items()
                if r.done}

    # ---- reporting ----

    def stats(self) -> dict:
        """Scheduler counters, under the reference's keys: slot occupancy
        (mean live fraction per decode step), aggregate tokens/s (admission
        time included in the denominator), admission/completion totals,
        and the page pool (one device read of the free count).
        ``prefill_traces`` counts distinct prefill/chunk lengths."""
        busy = self._decode_seconds + self._admit_seconds
        page_pool = None
        if self.paged:
            pages = self._total_pages
            used = pages - int(self._local(self._cache)["free_count"][0])
            page_pool = {"pages": pages, "used": used,
                         "reserved": self._reserved_pages,
                         "page_size": self.page_size,
                         "occupancy": used / pages}
        return {
            "page_pool": page_pool,
            "failed": self._failed,
            # bounded ring of RECENT failures; fail_reasons stays exact
            "failures": list(self._failures),
            "fail_reasons": dict(self._fail_reasons),
            "failure_log_cap": self._failure_cap,
            "flash_fallbacks": 0,          # the port's flash kernel never falls back
            "slots": self.slots,
            "max_len": self.max_len,
            "mesh": None if self.mesh is None else
            dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)),
            "submitted": self._next_rid,
            "completed": self._completed,
            "pending": self.pending,
            "live": self.live,
            "decode_steps": self._decode_steps,
            "tokens_generated": self._tokens_generated,
            "occupancy": (self._live_slot_steps
                          / max(self._decode_steps * self.slots, 1)),
            "decode_seconds": round(self._decode_seconds, 4),
            "admit_seconds": round(self._admit_seconds, 4),
            "init_seconds": round(self.init_seconds, 4),
            "tok_per_s": round(self._tokens_generated / busy, 1)
            if busy > 0 else 0.0,
            # phase-split throughput: prefill counts REAL prompt tokens
            # (bucket padding excluded) over admission time; decode counts
            # batched-decode tokens over decode time
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "prefill_toks_s": round(
                self._prefill_tokens / self._admit_seconds, 1)
            if self._admit_seconds > 0 else 0.0,
            "decode_toks_s": round(
                self._decode_tokens / self._decode_seconds, 1)
            if self._decode_seconds > 0 else 0.0,
            "prefill_traces": len(self._prefill_shapes),
            "prefill_chunk": self.prefill_chunk,
            "bucket_prompts": self.bucket_prompts,
            "weights_version": self.version,
        }

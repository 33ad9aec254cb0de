"""The moe, vlm, hybrid and encdec families on CPU ranks: expert
parallelism (``models.moe``, the engine's ``expert`` role), nested caches
on DTensor (``parallel.sharding.cache_sharding``), every family through
``Session.serve(mesh=)``, a moe ``serve_pool(mesh=)``, the sharded LFA
step, checkpoints of an expert-parallel layout and the training CLI —
each held against the port's own single-device output, which the other
``test_torch_*`` files hold against the JAX package.

One world of 4 gloo ranks serves the module (``torch_world.World``), apart
from ``test_torch_mesh.py``'s, so ``--dist loadfile`` runs the two files
side by side.  The single-device references (sessions, prompts, greedy
tokens, routing) are made once a rank and shared by the cases
(``_REF``).  As in ``test_torch_mesh.py``, mesh and single-device float32
sums differ in the last bits, so prompts are drawn until every
single-device greedy token leads its runner-up by more than ``MARGIN``:
a flipped token is then a fault.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_world import World

torch.set_num_threads(1)

MARGIN = 1e-4
ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b", "llava-next-34b",
         "zamba2-7b", "whisper-tiny")
MOE = ARCHS[:2]
MESHES = {"2x2": 2, "1x4": 4, "4x1": 1}          # name -> model axis of 4 ranks


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


# --------------------------------------------------------------------------
# rank-side helpers (run in the world's processes)
# --------------------------------------------------------------------------

_REF: dict = {}        # a rank's single-device references, shared by the cases


def _mesh(model):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model=model, device_type="cpu")


def _session(arch, **overrides):
    from repro_torch import Session
    key = ("session", arch, tuple(sorted(overrides.items())))
    if key not in _REF:
        _REF[key] = Session.init(arch, device="cpu", **overrides)
    return _REF[key]


def _inputs(cfg, tokens, rng):
    """The batch of ``tokens`` with the family's frontend input."""
    from repro_torch.data.pipeline import frontend_input
    batch = {"tokens": tokens}
    front = frontend_input(cfg)
    if front is not None:
        batch[front[0]] = torch.from_numpy(rng.standard_normal(
            (tokens.shape[0], cfg.frontend_len, front[1])).astype(np.float32))
    return batch


class _Routing:
    """Records every ``stable_top_k`` choice (``gate_idx``) of ``apply_moe``."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.top_k, self.seen = moe, moe.stable_top_k, []

    def __enter__(self):
        def spy(probs, k):
            vals, idx = self.top_k(probs, k)
            self.seen.append(idx.clone())
            return vals, idx
        self.moe.stable_top_k = spy
        return self

    def __exit__(self, *exc):
        self.moe.stable_top_k = self.top_k


def _greedy(handle, batch, n):
    """(tokens (B, n), the least top-1 lead over the runner-up)."""
    handle.reset()
    logits = handle.prefill(batch)
    out, leads = [], []
    for i in range(n):
        top = torch.topk(logits[:, -1].float(), 2).values
        leads.append(float((top[:, 0] - top[:, 1]).min()))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        if i + 1 < n:
            tok, logits = handle.decode(tok)
    return torch.cat(out, 1), min(leads)


def _reference(arch, wc, n=6, shape=(4, 8), **overrides):
    """(session, batch, greedy tokens, routing) on one device, a batch
    whose greedy tokens all lead by more than MARGIN."""
    key = ("ref", arch, wc, n, shape, tuple(sorted(overrides.items())))
    if key not in _REF:
        s = _session(arch, **overrides)
        h = s.serve(shape[0], 24, weight_cache=wc)
        rng = np.random.default_rng(0)
        for _ in range(50):
            tokens = torch.from_numpy(rng.integers(0, 500, size=shape).astype(np.int64))
            batch = _inputs(s.cfg, tokens, rng)
            with _Routing() as r:
                out, lead = _greedy(h, batch, n)
            if lead > MARGIN:
                break
        else:
            raise AssertionError("no prompt batch without near-ties")
        _REF[key] = (s, batch, out, r.seen)
    return _REF[key]


def _placements(t):
    return tuple(type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
                 for p in t.placements)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _serve(rank, n, arch, model_ax, wc):
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    s, batch, want, routing = _reference(arch, wc)
    mesh = _mesh(model_ax)
    h = s.serve(4, 24, weight_cache=wc, mesh=mesh)
    with _Routing() as r:
        got, _ = _greedy(h, batch, 6)
    assert torch.equal(got, want), (got, want)
    assert len(r.seen) == len(routing)
    assert all(torch.equal(a, b) for a, b in zip(r.seen, routing)), "routing differs"
    # every serve and cache leaf a DTensor, the cache placed by the rules
    flat = _flat(h.params)
    assert all(spmd.is_dtensor(t) for t in flat.values())
    rules = S.head_safe_rules(S.make_rules(mesh), s.cfg, mesh)
    cache = h.cache if isinstance(h.cache, dict) else {"state": h.cache}
    want_p = S.cache_sharding(h.cache, mesh, rules)
    want_p = want_p if isinstance(h.cache, dict) else {"state": want_p}
    placed = {k: _placements(t) for k, t in _flat(cache).items()}
    assert all(spmd.is_dtensor(t) for t in _flat(cache).values())
    assert placed == {k: tuple(type(p).__name__ + (f"({p.dim})" if hasattr(p, "dim") else "")
                               for p in v) for k, v in _flat(want_p).items()}
    # each rank's expert leaves hold E/m whole experts: (L, E/m, ...) blocks
    # whose other dims are whole once the FSDP shards are gathered at use
    experts = {k: t for k, t in _flat(spmd.localize(h.params)).items() if "/experts/" in k}
    e = s.cfg.num_experts
    local_e = {tuple(t.to_local().shape[1:2]) for t in experts.values()}
    whole = all(tuple(t.to_local().shape[2:]) == tuple(t.shape[2:]) for t in experts.values())
    return {"local_experts": sorted(local_e), "whole": whole, "experts": e,
            "placements": placed}


def _six_heads(rank, n):
    """whisper-tiny's 6 heads over model = 4: q/k/v replicated, tokens equal."""
    from repro_torch.parallel import sharding as S
    s, batch, want, _ = _reference("whisper-tiny", True, num_heads=6, num_kv_heads=6)
    mesh = _mesh(4)
    rules = S.head_safe_rules(S.make_rules(mesh), s.cfg, mesh)
    got, _ = _greedy(s.serve(4, 24, mesh=mesh), batch, 6)
    assert torch.equal(got, want)
    return rules["qkv"], rules["kv_qkv"]


def _indivisible_experts(rank, n):
    """Two experts over model = 4: the stack is tensor-parallel over core 0
    (``ffn``), its expert dim whole on every rank."""
    from repro_torch.configs import smoke_config
    over = {"num_experts": 2, "mpo": dataclasses.replace(
        smoke_config("phi3.5-moe-42b-a6.6b").mpo, shard_multiple=4)}
    s, batch, want, routing = _reference("phi3.5-moe-42b-a6.6b", False, **over)
    h = s.serve(4, 24, weight_cache=False, mesh=_mesh(4))
    with _Routing() as r:
        got, _ = _greedy(h, batch, 6)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(r.seen, routing))
    up = h.params["layers"]["moe"]["experts"]["w_up"]["cores"]
    return {k: _placements(t) for k, t in up.items()}


def _pool(rank, n):
    """A paged moe pool on (2, 2) against batch-1 serial generation."""
    s = _session("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(0)
    budgets = [6, 9, 4, 7]
    h1 = s.serve(1, 32)
    prompts, serial = [], []
    for size, budget in zip((8, 5, 8, 11), budgets):
        for _ in range(50):
            p = rng.integers(0, 500, size=size).astype(np.int32)
            out, lead = _greedy(h1, {"tokens": torch.from_numpy(p)[None].long()}, budget)
            if lead > MARGIN:
                break
        prompts.append(p)
        serial.append(out[0].numpy())
    pool = s.serve_pool(2, 32, mesh=_mesh(2), paged=True, page_size=8)
    rids = [pool.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    outs = pool.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], serial[i], err_msg=f"request {i}")
    st = pool.stats()
    assert st["completed"] == 4 and st["mesh"] == {"data": 2, "model": 2}
    assert st["page_pool"]["used"] == 0
    return True


def _train(rank, n, arch, sp, steps=3):
    """(losses, last grad norm, aux) of ``steps`` LFA steps on one device
    and on (2, 2)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import lightweight
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    from repro_torch.train.steps import TrainState, lm_loss, make_train_step
    mesh = _mesh(2)
    groups = 2                                     # the data axis: rows a rank runs

    def grouped_loss(model):
        """One device's loss as the mesh defines the step: the mean of the
        losses of the data ranks' row groups, each differentiated alone."""
        def loss_fn(p, b):
            parts = [lm_loss(model, p, {k: v.chunk(groups)[g] for k, v in b.items()})
                     for g in range(groups)]
            return (sum(l for l, _ in parts) / groups,
                    {k: sum(m[k] for _, m in parts) / (1 if k == "tokens" else groups)
                     for k in parts[0][1]})
        return loss_fn

    cfg = configs.smoke_config(arch, parallelism="sp" if sp else "tp")
    cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, mode="kernel"))
    seq = 32 + (cfg.frontend_len if cfg.family == "vlm" else 0)
    bf = make_batch_fn(cfg, ShapeConfig("t", "train", seq, 8))
    runs = []
    for m in (None, mesh):
        model = build(cfg, device="cpu")
        params = model.tree()
        if m is not None:
            rules = S.make_rules(m, fsdp=True, sp=sp)
            params = S.place_tree(params, S.tree_shardings(model.axes, params, m, rules), m)
            # over `model`: the experts (and their router's columns) alone
            # under sp, more under tp
            over_model = {k for k, t in _flat(params).items() if spmd.model_dim(t) is not None}
            assert (not sp or all("/moe/" in k for k in over_model)), over_model
            assert any("/experts/" in k for k in over_model) == bool(cfg.num_experts)
            # the frontend's rows (patches, frames) split over `data` with the tokens
            b0 = {k: torch.as_tensor(v) for k, v in bf(0).items()}
            placed = S.batch_sharding(b0, m, S.make_rules(m))
            assert all(placed[k] == S.placements(("data",), m) for k in b0), placed
        mask = lightweight.trainable_mask(params, mode="lfa")
        opt = optimizers.adamw(1e-3, mask=mask)
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, grouped_loss(model) if m is None else None)
        losses = []
        for i in range(steps):
            state, met = step(state, {k: torch.as_tensor(v) for k, v in bf(i).items()})
            losses.append(float(met["loss"]))
        runs.append((losses, float(met["grad_norm"]), float(met["aux"])))
    return runs


def _checkpoint(rank, n, directory):
    """moe parameters saved from (2, 2) restore on (1, 4) and on one device."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    s = _session("phi3.5-moe-42b-a6.6b")
    params = s.params
    m22, m14 = _mesh(2), _mesh(4)
    placed = S.place_tree(params, S.tree_shardings(s.axes, params, m22, S.make_rules(m22)),
                          m22)
    up = placed["layers"]["moe"]["experts"]["w_up"]["cores"]["c1"]
    assert _placements(up) == ("Replicate", "Shard(1)")           # experts over model
    mgr = CheckpointManager(directory)
    mgr.save(1, placed)
    assert mgr.latest_step() == 1
    sh14 = S.tree_shardings(s.axes, params, m14, S.make_rules(m14))
    t14, _ = mgr.restore(1, params, shardings=sh14, mesh=m14)
    t1, _ = mgr.restore(1, params, device="cpu")
    for k, want in _flat(params).items():
        got = _flat(t14)[k]
        assert spmd.is_dtensor(got) and got.device_mesh is m14, k
        assert torch.equal(got.full_tensor(), want), k
        assert not spmd.is_dtensor(_flat(t1)[k]) and torch.equal(_flat(t1)[k], want), k
    c14 = t14["layers"]["moe"]["experts"]["w_up"]["cores"]["c1"]
    return tuple(c14.to_local().shape[:2]), tuple(c14.shape[:2])


def _launch_train(rank, n):
    from repro_torch.launch import train as LT
    _, hist = LT.main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--seq-len", "32", "--model-parallel", "2",
                       "--compress", "int8"])
    return [h["loss"] for h in hist]


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("wc", [True, False], ids=["cached", "factorized"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_serving_matches_single_device(world, arch, mesh, wc):
    """``Session.serve(mesh=)`` gives the single device's greedy tokens and
    MoE routing (``gate_idx``) bit for bit; every serve and cache leaf is a
    DTensor and the caches, nested ones included, are placed by
    ``cache_sharding``; each rank's expert leaves hold E/m whole experts."""
    model_ax = MESHES[mesh]
    out = world.run(_serve, arch, model_ax, wc)
    assert all(o == out[0] for o in out)
    if arch in MOE:
        e = out[0]["experts"]
        assert out[0]["local_experts"] == [(e // model_ax,)] and out[0]["whole"]
    placed = out[0]["placements"]
    if arch == "zamba2-7b":
        assert placed["kv/pos"] == ("Replicate", "Replicate")
        assert placed["kv/k"][0] == "Shard(1)"           # batch over data
    if arch == "whisper-tiny":
        assert placed["self/pos"] == ("Replicate", "Replicate")
        assert placed["enc_out"] == ("Shard(0)", "Replicate")


def test_whisper_heads_that_do_not_divide_the_model_axis(world):
    out = world.run(_six_heads)
    assert out[0] == (None, None)


def test_experts_that_do_not_divide_the_model_axis(world):
    """phi3.5-moe with 2 experts on (1, 4): tensor parallelism over the
    stack's core 0, the single device's tokens and routing."""
    out = world.run(_indivisible_experts)
    assert out[0]["c0"] == ("Replicate", "Shard(4)")     # (L, E, d0, i, j, d1): j over model
    assert all("Shard(1)" not in p for p in out[0].values())


def test_moe_paged_pool_matches_serial(world):
    assert all(world.run(_pool))


@pytest.mark.parametrize("arch,sp", [("phi3.5-moe-42b-a6.6b", False),
                                     ("phi3.5-moe-42b-a6.6b", True),
                                     ("llama4-maverick-400b-a17b", True),
                                     ("llava-next-34b", True),
                                     ("zamba2-7b", False),
                                     ("whisper-tiny", False)],
                         ids=["phi3.5-tp", "phi3.5-sp", "llama4-sp", "llava", "zamba2",
                              "whisper"])
def test_sharded_lfa_steps_match_single_device(world, arch, sp):
    """Three LFA steps on (2, 2) against the same steps on one device (the
    mean of the two data groups' losses, as in ``test_torch_mesh.py``):
    losses within 1e-6 relative, the last gradient norm within 1e-4, the
    aux loss the same on every rank.  Expert leaves' gradients are summed
    over ``data`` only: a sum over ``model`` would scale them.  Every
    matrix runs the card's route, the MPO-linear kernels' wrappers on the
    rank's local shards (their plain versions here): the reconstruct mode
    rounds dy to bf16 before dW (the reference's), so the mesh's last-bit
    differences flip a rounding now and then, and AdamW's first step turns
    a flipped near-zero gradient into a whole ``lr`` step (one such flip of
    phi3.5-moe's 34656 trainable entries moves the second loss by 1e-5)."""
    out = world.run(_train, arch, sp)
    assert all(o == out[0] for o in out)
    (one, g1, a1), (mesh, g2, a2) = out[0]
    np.testing.assert_allclose(mesh, one, rtol=1e-6)
    np.testing.assert_allclose(g2, g1, rtol=1e-4)
    np.testing.assert_allclose(a2, a1, rtol=1e-6)


def test_expert_checkpoint_restores_on_another_layout(world, tmp_path):
    out = world.run(_checkpoint, str(tmp_path))
    assert out[0] == ((2, 1), (2, 4))                 # (L, E/m) of (L, E) on (1, 4)


def test_launch_train_cli_runs_moe_on_a_mesh(world):
    """``python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b
    --smoke --model-parallel 2 --compress int8`` on the ranks: EF-int8 over
    expert-parallel gradients, the same logged losses on every rank."""
    out = world.run(_launch_train)
    assert all(o == out[0] for o in out) and out[0]
    assert all(np.isfinite(out[0]))

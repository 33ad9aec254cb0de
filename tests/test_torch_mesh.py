"""The port's meshes on CPU ranks (``repro_torch.launch.mesh``,
``parallel.sharding`` / ``spmd``, ``make_serve_steps(mesh=)``, the sharded
train step, checkpoints across layouts), held against the port's own
single-device output — which the other ``test_torch_*`` files hold against
the JAX package.  It mirrors ``tests/test_serve_mesh.py``,
``tests/test_parallel.py`` and ``tests/test_system.py``'s sharded step.

One world of 4 gloo ranks serves the module (``torch_world.World``); each
test builds its meshes over it — (2, 2), (1, 4), (4, 1) — and every rank
runs the same calls and checks its own results.  Mesh and single-device
float32 sums differ in the last bits (partial sums over ``model``), so the
prompts are drawn until every single-device greedy token leads its
runner-up by more than 1e-4 (~5e-6 differences seen): a flipped token is
then a fault.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_world import World

torch.set_num_threads(1)

MARGIN = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(4)
    yield w
    w.close()


# --------------------------------------------------------------------------
# rank-side helpers (run in the world's processes)
# --------------------------------------------------------------------------


def _mesh(model):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(model=model, device_type="cpu")


def _greedy(handle, tokens, n):
    """(tokens (B, n), the least top-1 lead over the runner-up) of greedy
    generation through ``handle``."""
    handle.reset()
    logits = handle.prefill({"tokens": tokens})
    out, leads = [], []
    for i in range(n):
        top = torch.topk(logits[:, -1].float(), 2).values
        leads.append(float((top[:, 0] - top[:, 1]).min()))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        if i + 1 < n:
            tok, logits = handle.decode(tok)
    return torch.cat(out, 1), min(leads)


def _prompts(handle, vocab, shape, n, seed=0):
    """A prompt batch whose greedy tokens all lead by more than MARGIN."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        tokens = torch.from_numpy(rng.integers(0, vocab, size=shape).astype(np.int64))
        out, lead = _greedy(handle, tokens, n)
        if lead > MARGIN:
            return tokens, out
    raise AssertionError("no prompt batch without near-ties")


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


def _serve_parity(rank, n, model_ax, paged):
    from repro_torch import Session
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    mesh = _mesh(model_ax)
    s = Session.init("qwen3-14b", device="cpu")
    kw = {"paged": True, "page_size": 8} if paged else {}
    one = s.serve(4, 24, **kw)
    tokens, want = _prompts(one, 500, (4, 8), 8)
    h = s.serve(4, 24, mesh=mesh, **kw)
    got, _ = _greedy(h, tokens, 8)
    assert torch.equal(got, want), (got, want)
    rules = S.head_safe_rules(S.make_rules(mesh), s.cfg, mesh)
    # every serve leaf is a DTensor; the dense Ws carry model shards
    flat = _flat(h.params)
    assert all(spmd.is_dtensor(t) for t in flat.values())
    dense = {k: _placements(t) for k, t in flat.items() if k.endswith("/w")}
    sharded = {k: p for k, p in dense.items() if "Shard" in "".join(p)}
    assert len(sharded) >= 4, dense
    cache = h.cache
    assert all(spmd.is_dtensor(t) for t in cache.values())
    if paged:
        # the paged flash layout: in-page positions over model, bookkeeping replicated
        assert _placements(cache["k_pages"]) == ("Replicate", "Shard(2)")
    else:
        # flash-decoding layout: batch over data, sequence over model
        assert _placements(cache["k"]) == ("Shard(1)", "Shard(2)")
    assert _placements(cache["pos"]) == ("Replicate", "Replicate")
    return {"kv_qkv": rules["kv_qkv"], "qkv": rules["qkv"], "sharded_w": len(sharded)}


def _factorized_tables(rank, n):
    from repro_torch import Session, configs
    from repro_torch.parallel import spmd
    mesh = _mesh(2)
    cfg = configs.smoke_config("qwen3-14b", vocab_size=2048)
    cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, bond_embed=4))
    s = Session.init(cfg, device="cpu")
    h = s.serve(4, 24, mesh=mesh)
    embed = h.params["embed"]
    assert "cores" in embed and "w" not in embed, list(embed)
    vocab, d = cfg.vocab_size, cfg.d_model
    for k, t in _flat(h.params).items():
        assert tuple(t.shape[-2:]) != (vocab, d), f"a dense [vocab, d] table: {k}"
    for name, core in embed["cores"].items():
        assert spmd.is_dtensor(core) and core.device_mesh is mesh, name
    tokens, want = _prompts(s.serve(4, 24), 500, (4, 8), 6)
    got, _ = _greedy(h, tokens, 6)
    assert torch.equal(got, want)
    return True


def _unfactorized(rank, n):
    from repro_torch import Session, configs
    mesh = _mesh(2)
    cfg = configs.smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, enabled=False))
    s = Session.init(cfg, device="cpu")
    tokens, want = _prompts(s.serve(4, 24), 500, (4, 8), 6)
    h = s.serve(4, 24, mesh=mesh)
    got, _ = _greedy(h, tokens, 6)
    assert torch.equal(got, want)
    return {k: _placements(h.params[k]["w"]) for k in ("embed", "lm_head")}


def _pool(rank, n, paged):
    from repro_torch import Session
    mesh = _mesh(2)
    s = Session.init("qwen3-14b", device="cpu")
    rng = np.random.default_rng(0)
    budgets = [6, 9, 4, 7]
    h1 = s.serve(1, 32)
    prompts, serial = [], []
    for size, budget in zip((8, 5, 8, 11), budgets):
        for _ in range(50):
            p = rng.integers(0, 500, size=size).astype(np.int32)
            out, lead = _greedy(h1, torch.from_numpy(p)[None].long(), budget)
            if lead > MARGIN:
                break
        prompts.append(p)
        serial.append(out[0].numpy())
    kw = {"paged": True, "page_size": 8} if paged else {}
    pool = s.serve_pool(2, 32, mesh=mesh, **kw)
    rids = [pool.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    outs = pool.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], serial[i], err_msg=f"request {i}")
    st = pool.stats()
    assert st["completed"] == 4 and st["mesh"] == {"data": 2, "model": 2}
    if paged:
        assert st["page_pool"]["used"] == 0
    return True


def _nondividing(rank, n):
    from repro_torch.launch.mesh import make_host_mesh
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=3, device_type="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        make_host_mesh(model=0, device_type="cpu")
    return True


def _train(rank, n, model_ax, sp, opt_name, steps=3):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import lightweight
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    from repro_torch.train.steps import TrainState, lm_loss, make_train_step
    mesh = _mesh(model_ax)
    groups = n // model_ax                             # the data axis: rows a rank runs

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

    cfg = configs.smoke_config("qwen3-14b", d_model=64, num_heads=4, num_kv_heads=2,
                               **({"parallelism": "sp"} if sp else {}))
    bf = make_batch_fn(cfg, ShapeConfig("t", "train", 32, 8))
    runs = []
    for m in (None, mesh):
        model = build(cfg, device="cpu")
        params = model.tree()
        if m is not None:
            rules = S.make_rules(m, fsdp=True, sp=sp)
            params = S.place_tree(params, S.tree_shardings(model.axes, params, m, rules), m)
            assert any(spmd.model_dim(t) is not None
                       for t in lightweight.leaves(params)) != sp
        mask = lightweight.trainable_mask(params, mode="lfa")
        opt = getattr(optimizers, opt_name)(1e-3, mask=mask)
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt, grouped_loss(model) if m is None else None)
        losses = []
        for i in range(steps):
            state, met = step(state, {k: torch.as_tensor(v) for k, v in bf(i).items()})
            losses.append(float(met["loss"]))
        runs.append((losses, float(met["grad_norm"])))
    return runs


def _rows(rank, n):
    """The rows each rank's loss sees in a train step on (2, 2) and on
    (1, 4): its data coordinate's half of 8, or all 8."""
    from repro_torch import configs
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers
    from repro_torch.parallel import sharding as S
    from repro_torch.train.steps import TrainState, lm_loss, make_train_step
    cfg = configs.smoke_config("qwen3-14b", d_model=64, num_heads=4, num_kv_heads=2)
    tokens = torch.arange(8)[:, None].repeat(1, 16)    # row r holds r
    batch = {"tokens": tokens, "labels": tokens}
    seen = []
    for model_ax in (2, 4):
        mesh = _mesh(model_ax)
        model = build(cfg, device="cpu")
        params = model.tree()
        params = S.place_tree(params, S.tree_shardings(
            model.axes, params, mesh, S.make_rules(mesh, fsdp=True)), mesh)
        opt = optimizers.sgdm(1e-3)

        def loss_fn(p, b, model=model):
            seen.append(b["tokens"][:, 0].tolist())
            return lm_loss(model, p, b)
        step = make_train_step(model, opt, loss_fn)
        step(TrainState(params, opt.init(params)), batch)
    return seen


def _reshard(rank, n, directory):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel import sharding as S
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    mesh1 = _mesh(1)                                   # (4, 1)
    t1 = S.place_tree(tree, {"w": S.placements(("data",), mesh1)}, mesh1)
    mgr = CheckpointManager(directory)                 # rank 0 writes in the background
    mgr.save(1, t1)
    assert mgr.latest_step() == 1                      # every rank, once rank 0 is done
    mesh2 = _mesh(2)                                   # (2, 2)
    sh2 = {"w": S.placements(("data", "model"), mesh2)}
    t2, meta = mgr.restore(1, tree, shardings=sh2, mesh=mesh2)
    assert t2["w"].device_mesh is mesh2 and _placements(t2["w"]) == ("Shard(0)", "Shard(1)")
    assert tuple(t2["w"].to_local().shape) == (4, 4)
    torch.testing.assert_close(t2["w"].full_tensor(), tree["w"], rtol=0, atol=0)
    # a DTensor template comes back on its own placements
    t3, _ = mgr.restore(1, t1)
    assert _placements(t3["w"]) == _placements(t1["w"])
    torch.testing.assert_close(t3["w"].full_tensor(), tree["w"], rtol=0, atol=0)
    return meta["step"]


def _local_shards(rank, n):
    from repro_torch import Session, configs
    from repro_torch.kernels import mpo_linear as KM
    mesh = _mesh(2)
    cfg = configs.smoke_config("qwen3-14b")
    cfg = dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, mode="kernel"))
    s = Session.init(cfg, device="cpu")
    full = s.params["layers"]["mlp"]["w_up"]["cores"]["c0"].shape      # (L, d0, i, j, d1)
    seen = []
    plain = KM.mpo_linear_plain

    def spy(cores, x):
        seen.append(tuple(tuple(c.shape) for c in cores))
        assert not any(type(c).__name__ == "DTensor" for c in (*cores, x))
        return plain(cores, x)

    spy.calls = 0
    KM.mpo_linear_plain = spy
    try:
        tokens = torch.zeros((2, 8), dtype=torch.long)
        want = s.serve(2, 16, weight_cache=False).generate({"tokens": tokens}, 2)
        seen.clear()
        got = s.serve(2, 16, weight_cache=False, mesh=mesh).generate({"tokens": tokens}, 2)
    finally:
        KM.mpo_linear_plain = plain
    assert seen, "the kernel path did not run"
    half = tuple(full[1:3]) + (full[3] // 2, full[4])
    assert half in {shapes[0] for shapes in seen}, (half, seen[:4])
    assert tuple(full[1:]) not in {shapes[0] for shapes in seen if shapes[0][:2] == full[1:3]}
    return torch.equal(got, want)


def _ssm(rank, n):
    from repro_torch import Session
    from repro_torch.parallel import spmd
    mesh = _mesh(2)
    s = Session.init("mamba2-130m", device="cpu")
    one = s.serve(4, 24)
    tokens, want = _prompts(one, 500, (4, 8), 6)
    h = s.serve(4, 24, mesh=mesh)
    assert spmd.is_dtensor(h.cache)
    got, _ = _greedy(h, tokens, 6)
    assert torch.equal(got, want)
    return _placements(h.cache)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("model_ax", [2, 4])
def test_mesh_serve_parity_and_dense_w_placements(world, model_ax, paged):
    """``Session.serve(mesh=)`` on (2, 2) and (1, 4) gives the
    single-device greedy tokens; every serve and cache leaf is a DTensor,
    the dense Ws carry model shards, the cache is in the flash-decoding
    layout.  On (1, 4) ``head_safe_rules`` drops ``kv_qkv``: 2 KV heads do
    not divide 4."""
    out = world.run(_serve_parity, model_ax, paged)
    assert all(o == out[0] for o in out)
    assert out[0]["qkv"] == ("model",)
    assert out[0]["kv_qkv"] == (None if model_ax == 4 else ("model",))


def test_mesh_factorized_tables_stay_factorized(world):
    assert all(world.run(_factorized_tables))


def test_mesh_unfactorized_model(world):
    """``MPOConfig(enabled=False)`` on (2, 2): the dense embedding spread
    over ``model`` along the vocabulary (each rank looks up its rows, the
    sums added), the dense head column-parallel; the single device's
    tokens."""
    out = world.run(_unfactorized)
    assert out[0] == {"embed": ("Replicate", "Shard(0)"), "lm_head": ("Replicate", "Shard(1)")}


@pytest.mark.parametrize("paged", [False, True])
def test_mesh_pool_matches_serial(world, paged):
    assert all(world.run(_pool, paged))


def test_mesh_errors(world):
    """No axes: the reference's ValueError (make_serve_steps and a raw
    Session); ``make_host_mesh`` rejects a model axis that does not divide
    the world.  Every family builds its steps on a mesh (the moe family
    here); what a family still lacks raises as off the mesh: a paged cache
    for the hybrid family."""
    from repro_torch import Session, configs
    from repro_torch.models.model import build
    from repro_torch.train.steps import make_serve_steps
    assert all(world.run(_nondividing))
    standin = type("M", (), {"mesh_dim_names": ("data", "model"), "shape": (1, 1)})()
    cfg = configs.smoke_config("qwen3-14b")
    model = build(cfg, device="cpu")
    with pytest.raises(ValueError, match="axes="):
        make_serve_steps(model, mesh=standin)
    with pytest.raises(ValueError, match="logical-axis tree"):
        Session(cfg, model).serve(2, 16, mesh=standin)
    moe = build(configs.smoke_config("phi3.5-moe-42b-a6.6b"), device="cpu")
    steps = make_serve_steps(moe, mesh=standin, axes=moe.axes)
    assert steps.prefill is not None and steps.prefill_chunk is not None
    hybrid = build(configs.smoke_config("zamba2-7b"), device="cpu")
    steps = make_serve_steps(hybrid, mesh=standin, axes=hybrid.axes, paged=True)
    with pytest.raises(ValueError, match="paged KV cache is not supported for family 'hybrid'"):
        steps.init_serve(hybrid.tree(), 2, 16)


@pytest.mark.parametrize("sp,opt_name", [(False, "adamw"), (True, "adamw"),
                                         (False, "adafactor")],
                         ids=["tp", "sp", "tp-adafactor"])
def test_sharded_lfa_steps_match_single_device(world, sp, opt_name):
    """Three LFA steps (FSDP + tp rules, or the sp rules) on (2, 2) against
    the same steps on one device: losses within 1e-6 relative and the last
    gradient norm within 1e-4 (the mesh sums partial products over
    `model`; ~5e-7 and ~4e-5 seen), the same on every rank.  adafactor's
    factored statistics stay replicated DTensors.  The mesh spreads the 8
    rows over `data`, each rank differentiating its 4: the one-device steps
    take the same two row groups' mean loss, because the reconstruct-mode
    backward rounds each group's dW to bf16 before the groups are summed
    (as the reference's bf16 einsum does), about 3e-3 apart from the dW of
    all 8 rows."""
    out = world.run(_train, 2, sp, opt_name)
    assert all(o == out[0] for o in out)
    (one, g1), (mesh, g2) = out[0]
    np.testing.assert_allclose(mesh, one, rtol=1e-6)
    np.testing.assert_allclose(g2, g1, rtol=1e-4)


def test_train_step_spreads_rows_over_data(world):
    """Data parallelism: on (2, 2) the loss of each rank sees the 4 rows of
    its data coordinate (ranks 0, 1: rows 0-3; ranks 2, 3: rows 4-7); on
    (1, 4) every rank sees all 8."""
    out = world.run(_rows)
    for rank, seen in enumerate(out):
        half = list(range(4)) if rank < 2 else list(range(4, 8))
        assert seen == [half, list(range(8))]


def test_flash_decode_stats_merge_a_split_pool():
    """``flash_decode_attention(stats=True)`` over each half of every page's
    positions, merged as ``spmd.combine_softmax`` merges the ranks of a
    pool split over ``model``, gives the unsplit result (the plain version
    here; chip_smoke.py holds the kernel to it on the card)."""
    from repro_torch.kernels import decode_attention as DA
    g = torch.Generator().manual_seed(0)
    b, kv, gq, dh, p, ps, mp = 3, 2, 2, 16, 12, 8, 4
    q = torch.randn(b, kv, gq, dh, generator=g)
    kp, vp = (torch.randn(p, ps, kv, dh, generator=g) for _ in range(2))
    table = torch.randperm(p, generator=g)[:b * mp].reshape(b, mp).int()
    lengths = torch.tensor([0, 13, 32], dtype=torch.int32)
    bias = torch.where(torch.arange(mp * ps)[None] < lengths[:, None].long(), 0.0,
                       DA.MASK_VALUE).float()
    whole = DA.flash_decode_attention(q, kp, vp, table, lengths, bias, softcap=30.0)
    parts = []
    npages = (lengths + ps - 1) // ps
    for o0 in (0, ps // 2):
        sl = slice(o0, o0 + ps // 2)
        parts.append(DA.flash_decode_attention(
            q, kp[:, sl].contiguous(), vp[:, sl].contiguous(), table,
            (npages * (ps // 2)).int(),
            bias.unflatten(-1, (mp, ps))[..., sl].flatten(-2).contiguous(),
            softcap=30.0, stats=True))
    big = torch.maximum(parts[0][1], parts[1][1])
    num = sum(o.float() * l * torch.exp(m - big) for o, m, l in parts)
    den = sum(l * torch.exp(m - big) for _, m, l in parts)
    torch.testing.assert_close(num / den.clamp(min=1e-30), whole, rtol=1e-5, atol=1e-6)
    assert float(parts[0][2][0].abs().max()) == 0.0      # an empty slot: l = 0


def test_checkpoint_saved_on_one_layout_restores_on_another(world, tmp_path):
    assert world.run(_reshard, str(tmp_path)) == [1] * 4


def test_kernel_path_gets_local_shards(world):
    """With the ``kernel`` mode forced, the MPO-linear plain version (the
    kernel's CPU stand-in) receives plain tensors whose core 0 leg over
    ``model`` is half the full leg on (2, 2), and the tokens are the
    single device's."""
    assert all(world.run(_local_shards))


def test_mesh_ssm_serving(world):
    """Smoke mamba2-130m on (2, 2): the state spread over the mesh (batch
    over data, N over model) and the single-device tokens."""
    out = world.run(_ssm)
    assert out[0] == ("Shard(1)", "Shard(3)")

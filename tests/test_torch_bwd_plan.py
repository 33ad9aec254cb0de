"""The MPO-linear cores-backward kernel's plan, scratch layout, index maps and
jobs (``repro_torch/kernels/mpo_linear.py``: ``_bwd_plan``, ``_bwd_layout``,
``_bwd_maps``, ``_bwd_jobs``) on the CPU.

The kernel (``csrc/mpo_linear_bwd.cu``) runs only on the card, but what it
computes is laid out here: ``_emulate`` replays it in torch, float32 — the
chain jobs, the tile pass (the plan's split and tiles, each block's fixed
walk, dL per pair, the dR shares summed by cluster in rank order) and the
epilogue jobs — from a workspace filled with NaN, so a read of a float no
job or tile wrote shows.  It is held against the reference's
``_bwd_cores_call`` (interpret mode) and ``jax.grad`` at
``tests/test_kernel_vjp.py``'s four shapes, and against the plain version at
bert-base's attention matrix, at 2e-5 of each gradient's largest magnitude
(``tests/test_torch_kernels.py``'s float32 tolerance: the same f32 function
summed in another order).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mpo as JM
from repro.kernels.mpo_linear import _bwd_cores_call
from repro.kernels.ref import mpo_linear_ref
from repro_torch import configs
from repro_torch.kernels import mpo_linear as TMK

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = 2e-5
SMS = (132, 114, 8)


def _matrices() -> dict:
    """bert-base's attention and FFN matrices and mamba2-130m's projections,
    as core shapes."""
    from repro_torch.core.layers import cores_to_list
    from repro_torch.models import mamba as TMB
    from repro_torch.models import model as TModel
    with torch.device("meta"):
        bert = TModel.transformer.init(torch.Generator(), configs.get_config("bert-base"))
        mamba = TMB.init(torch.Generator(), configs.get_config("mamba2-130m"))

    def shapes(lin):
        return [tuple(c.shape[1:]) for c in cores_to_list(lin["cores"])]

    return {"attn": shapes(bert["layers"]["attn"]["wq"]),
            "w_up": shapes(bert["layers"]["mlp"]["w_up"]),
            "w_down": shapes(bert["layers"]["mlp"]["w_down"]),
            "in_proj": shapes(mamba["layers"]["in_proj"]),
            "out_proj": shapes(mamba["layers"]["out_proj"])}


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("name", ["attn", "w_up", "w_down", "in_proj", "out_proj"])
def test_bwd_plan_admits_the_models_matrices(name, sms):
    """Both orientations, both dtypes: a plan within shared memory, clusters
    of at most 8, no more blocks than SMs, whole clusters; at bert-base's
    matrices the scratch is below an f32 dW (mamba2-130m's is recorded, not
    gated: its out_proj's L and dL alone are as large)."""
    s = _matrices()[name]
    for sh in (s, [(d0, j, i, d1) for d0, i, j, d1 in s]):
        i_dim = math.prod(c[1] for c in sh)
        j_dim = math.prod(c[2] for c in sh)
        for dtype in ("bfloat16", "float32"):
            plan = TMK._bwd_plan(tuple(sh), dtype, sms)
            assert plan is not None, (name, sh, dtype)
            assert plan.smem <= TMK.SMEM_LIMIT
            assert plan.smem == TMK._bwd_smem_bytes(
                sh[plan.split][0], math.prod(c[1] for c in sh[plan.split:]),
                math.prod(c[2] for c in sh[plan.split:]), plan.tr, plan.tc, dtype)
            assert 1 <= plan.cluster <= 8 and plan.blocks % plan.cluster == 0
            assert 1 <= plan.blocks <= sms
            if name in ("attn", "w_up", "w_down"):
                assert plan.workspace < 4 * i_dim * j_dim, (name, sms, plan)
            assert TMK.kernel_eligible(sh, dtype=dtype, train=True)


def test_bwd_plan_takes_large_tiles_at_bert_base():
    """x and dy are read once per tile: attention takes 128 x 64 tiles (72,
    one wave), the FFN matrices 128 x 128 (144 tiles, two a block), at the
    bond the forward splits at."""
    mats = _matrices()
    a = TMK._bwd_plan(tuple(mats["attn"]))
    assert (a.split, a.tr, a.tc, a.tiles, a.blocks, a.cluster) == (3, 128, 64, 72, 72, 8)
    for name in ("w_up", "w_down"):
        p = TMK._bwd_plan(tuple(mats[name]))
        assert (p.split, p.tr, p.tc, p.tiles, p.blocks, p.cluster) == (3, 128, 128, 144, 72, 8)


def test_bwd_maps_number_every_pair_once():
    for sh in _matrices().values():
        plan = TMK._bwd_plan(tuple(sh))
        pmi, pmj, qmi, qmj = TMK._bwd_maps(sh, plan.split)
        for mi, mj in ((pmi, pmj), (qmi, qmj)):
            rows = (mi[:, None] + mj[None, :]).flatten()
            assert torch.equal(rows.sort().values, torch.arange(rows.numel()))


def _run_jobs(jobs, steps, cores, outs, ws):
    """The job runner (``run_jobs`` in the CUDA source) in torch: each job's
    batched product over its strided operands, the steps in order."""
    def index(off, strides, dims):
        idx = torch.tensor(off)
        for k, (st, n) in enumerate(zip(strides, dims)):
            shape = [1] * len(dims)
            shape[k] = n
            idx = idx + st * torch.arange(n).view(shape)
        return idx

    def operand(src, idx):
        if src == TMK.BWD_ONES:
            return torch.ones(idx.shape)
        flat = ws if src == TMK.BWD_WS else cores[src].reshape(-1).float()
        return flat[idx]

    for step in range(steps):
        for j in jobs:
            f = dict(zip(TMK.JOB_FIELDS, j))
            if f["step"] != step:
                continue
            z, m, k1, k2, n = f["Z"], f["M"], f["K1"], f["K2"], f["N"]
            a = operand(f["a_src"], index(f["a_off"], (f["a_sz"], f["a_sm"], f["a_s1"], f["a_s2"]),
                                          (z, m, k1, k2))).reshape(z, m, k1 * k2)
            b = operand(f["b_src"], index(f["b_off"], (f["b_sz"], f["b_s1"], f["b_s2"], f["b_sn"]),
                                          (z, k1, k2, n))).reshape(z, k1 * k2, n)
            out = a @ b
            idx = index(f["c_off"], (f["c_sz"], f["c_sm"], f["c_sn"]), (z, m, n)).flatten()
            assert idx.unique().numel() == idx.numel()
            dst = ws if f["c_dst"] == TMK.BWD_WS else outs[f["c_dst"]].view(-1)
            dst[idx] = out.flatten().to(dst.dtype)


def _emulate(cores, x, dy, needs=None, sms=132):
    """The kernel's order of sums, float32, from a NaN-filled workspace."""
    shapes = tuple(tuple(c.shape) for c in cores)
    n = len(cores)
    needs = [True] * n if needs is None else list(needs)
    plan = TMK._bwd_plan(shapes, "float32", sms)
    chain, csteps, epi, esteps = TMK._bwd_jobs(shapes, plan, needs)
    pmi, pmj, qmi, qmj = TMK._bwd_maps(shapes, plan.split)
    ws = torch.full((plan.workspace // 4,), float("nan"))
    outs = [torch.full_like(c, float("nan")) if k else None for c, k in zip(cores, needs)]
    _run_jobs(chain, csteps, cores, outs, ws)

    s = plan.split
    ds = shapes[s][0]
    i_s = math.prod(c[1] for c in shapes[s:])
    j_s = math.prod(c[2] for c in shapes[s:])
    i_p = x.shape[1] // i_s
    j_p = dy.shape[1] // j_s
    q = i_s * j_s
    pi, pj = plan.tr // i_s, plan.tc // j_s
    tiles_j = -(-j_p // pj)
    assert plan.tiles == -(-i_p // pi) * tiles_j
    L = ws[plan.phi[-1]:plan.phi[-1] + i_p * j_p * ds].view(i_p * j_p, ds)
    R = ws[plan.rho[0]:plan.rho[0] + q * ds].view(q, ds)
    dL = ws[plan.mu[-1]:plan.mu[-1] + i_p * j_p * ds].view(i_p * j_p, ds)
    rows_q = (qmi[:, None] + qmj[None, :]).flatten()
    x3 = x.float().view(-1, i_p, i_s)
    dy3 = dy.float().view(-1, j_p, j_s)
    share = torch.zeros(plan.blocks, q, ds)
    for b in range(plan.blocks):                 # each block's fixed walk
        for t in range(b, plan.tiles, plan.blocks):
            ti, tj = divmod(t, tiles_j)
            ips = torch.arange(ti * pi, min(i_p, ti * pi + pi))
            jps = torch.arange(tj * pj, min(j_p, tj * pj + pj))
            g = torch.einsum("mai,mbj->abij", x3[:, ips], dy3[:, jps])
            gp = torch.zeros(len(ips), len(jps), q)
            gp[:, :, rows_q] = g.reshape(len(ips), len(jps), q)
            rows_p = pmi[ips][:, None] + pmj[jps][None, :]
            if any(needs[:s]):
                dL[rows_p.flatten()] = (gp @ R).reshape(-1, ds)
            if any(needs[s:]):
                share[b] += torch.einsum("abq,abd->qd", gp, L[rows_p])
    part = ws[plan.part:plan.part + plan.blocks // plan.cluster * q * ds].view(-1, q, ds)
    for c in range(part.shape[0]):               # the cluster's ranks in order
        acc = torch.zeros(q, ds)
        for r in range(plan.cluster):
            acc = acc + share[c * plan.cluster + r]
        part[c] = acc
    _run_jobs(epi, esteps, cores, outs, ws)
    return outs


def _inputs(dims, n, bond, m, seed=0):
    spec = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(seed)
    bonds = math.prod(spec.bonds()) if n > 1 else 1
    sigma = (1.0 / dims[0] / bonds) ** (1.0 / (2 * n))
    cores = [(rng.standard_normal(s) * sigma).astype(np.float32) for s in spec.core_shapes()]
    x = rng.standard_normal((m, dims[0])).astype(np.float32)
    dy = np.random.default_rng(9).standard_normal((m, dims[1])).astype(np.float32)
    return cores, x, dy


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("dims,n,bond,m", [
    ((24, 36), 3, None, 37), ((64, 96), 3, 8, 19), ((64, 64), 5, 8, 16),
    ((128, 48), 4, 6, 5)])                # tests/test_kernel_vjp.py's shapes
def test_bwd_emulation_matches_pallas_and_grad(dims, n, bond, m, sms):
    """The kernel's order of sums against the reference's ``_bwd_cores_call``
    (interpret mode) and ``jax.grad`` of ``sum(dy * mpo_linear_ref(cores,
    x))``; a call that skips a core gives the others' values unchanged."""
    cores, x, dy = _inputs(dims, n, bond, m)
    jc = [jnp.asarray(c) for c in cores]
    pallas = _bwd_cores_call(jc, jnp.asarray(x), jnp.asarray(dy), 16, True)
    grad = jax.grad(lambda cs: jnp.sum(mpo_linear_ref(list(cs), jnp.asarray(x)) * dy))(
        tuple(jc))
    tc = [torch.from_numpy(c) for c in cores]
    got = _emulate(tc, torch.from_numpy(x), torch.from_numpy(dy), sms=sms)
    for k, g in enumerate(got):
        assert torch.isfinite(g).all(), k
        _close(g, pallas[k])
        _close(g, grad[k])
    for skip in range(n):
        needs = [k != skip for k in range(n)]
        some = _emulate(tc, torch.from_numpy(x), torch.from_numpy(dy), needs, sms=sms)
        assert some[skip] is None
        assert all(torch.equal(a, b) for a, b, k in zip(some, got, needs) if k)


@pytest.mark.parametrize("sms", [132, 8])
def test_bwd_emulation_matches_plain_at_bert_attention(sms):
    """Full-width bert-base attention (768 x 768: 72 tiles, 9 clusters of 8
    at 132 SMs, nine tiles a block at 8) at 24 rows, against the plain
    version; the central core skipped, as ``freeze_central_grads`` asks."""
    s = _matrices()["attn"]
    rng = np.random.default_rng(3)
    cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32)) for c in s]
    x = torch.from_numpy(rng.standard_normal((24, 768)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((24, 768)).astype(np.float32))
    ref = TMK.mpo_linear_bwd_cores_plain(cores, x, dy)
    got = _emulate(cores, x, dy, sms=sms)
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= TOL * r.abs().max()
    central = len(cores) // 2
    some = _emulate(cores, x, dy, [k != central for k in range(len(cores))], sms=sms)
    assert some[central] is None
    assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got)) if k != central)


def test_bwd_jobs_follow_needs():
    """A skipped core has no gradient job; no cotangent is carried past the
    last core that needs it; nothing at all is needed for a prefix (suffix)
    that no core of it needs.  At bert-base's attention matrix the chains
    take two steps (phi_1 and rho_4 are cores 0 and 4 themselves) and every
    epilogue sum is at most ``BWD_KSLICE`` long: mu_2, mu_1 (= dC_0) and
    lam_4 (1024 terms each) run as four slices and a sum."""
    s = tuple(_matrices()["attn"])
    plan = TMK._bwd_plan(s)
    n = len(s)

    def writes(jobs):
        return sorted(j[TMK.JOB_FIELDS.index("c_dst")] for j in jobs
                      if j[TMK.JOB_FIELDS.index("c_dst")] >= 0)

    chain, csteps, epi, esteps = TMK._bwd_jobs(s, plan, [True] * n)
    assert (len(chain), csteps, esteps) == (n - 2, 2, 4) and writes(chain) == []
    k1, k2 = TMK.JOB_FIELDS.index("K1"), TMK.JOB_FIELDS.index("K2")
    assert max(j[k1] * j[k2] for j in epi) <= TMK.BWD_KSLICE
    assert writes(epi) == list(range(n))
    _, _, epi2, _ = TMK._bwd_jobs(s, plan, [k != 2 for k in range(n)])
    assert writes(epi2) == [0, 1, 3, 4] and len(epi2) == len(epi) - 1
    _, _, epi3, _ = TMK._bwd_jobs(s, plan, [k >= plan.split for k in range(n)])
    assert writes(epi3) == list(range(plan.split, n))
    dst, off = TMK.JOB_FIELDS.index("c_dst"), TMK.JOB_FIELDS.index("c_off")
    assert not any(j[dst] == TMK.BWD_WS and j[off] in plan.mu for j in epi3)

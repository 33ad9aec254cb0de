"""The float32 forward for the narrow shapes (``csrc/mpo_linear.cu``, route
``"cuda_core"``): which matrices of every configuration take it, its launch
plan, and its stage and tile index maps replayed on the CPU.

The configurations are the reference's (``repro.configs.ARCHS``, full and
smoke, both orientations), their core shapes from ``jax.eval_shape`` (no
weights drawn).  ``forward_kernel`` names ``"cuda_core"`` for exactly the
float32 matrices pinned in ``CUDA_CORE``, and ``kernel_eligible`` gives the
answers it gave before the kernel was redesigned, so the engine plans no
matrix differently.  The plan's shared memory stays within one block's,
its workspace (the split-I partials) below a quarter of the bf16 W, and at
few rows its splits fill two waves of the card where the workspace and the
stages allow.  ``_replay`` walks the kernel's stages and tiles with its
padded digit groups, its L, P and R and its masks, in float64 on the CPU:
W and ``x @ W`` come out of it exactly as ``mpo.reconstruct`` gives them, at
padded, cut and unpadded groups and at every bond.  The kernel itself runs
only on the card (``tests/test_torch_mpo_mma.py -m cuda``)."""

import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import layers as JL
from repro.models import model as JModel
from repro_torch.core import mpo as TM
from repro_torch.kernels import mpo_linear as TMK

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each


def _matrix_shapes(arch, smoke):
    """{name: core shapes} of every factorized matrix of the reference
    model (one layer's, one expert's), plus the tied logits' E^T."""
    cfg = jconfigs.smoke_config(arch) if smoke else jconfigs.get_config(arch)
    params, _ = JL.split_annotations(
        jax.eval_shape(JModel.build(cfg).init, jax.random.PRNGKey(0)))
    out = {"embed": [c.shape for c in JL.cores_to_list(params["embed"]["cores"])]}
    out["embed_T"] = [(a, j, i, b) for a, i, j, b in out["embed"]]
    if "lm_head" in params:
        out["lm_head"] = [c.shape for c in JL.cores_to_list(params["lm_head"]["cores"])]
    blocks = [params[k] for k in ("layers", "shared_attn", "encoder", "decoder") if k in params]
    blocks += [{"mamba": params["mamba"]}] if "mamba" in params else []
    for block in blocks:
        for grp in ("attn", "xattn", "mlp", "mamba"):
            for name, lin in block.get(grp, {}).items():
                if isinstance(lin, dict) and "cores" in lin:
                    out[name] = [c.shape[1:] for c in JL.cores_to_list(lin["cores"])]
    for name, lin in params.get("layers", {}).get("moe", {}).get("experts", {}).items():
        out[f"experts/{name}"] = [c.shape[2:] for c in JL.cores_to_list(lin["cores"])]
    return {k: tuple(tuple(int(d) for d in s) for s in v) for k, v in out.items()}


def _swap(shapes):
    return tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)


_ATTN = {"wq", "wk", "wv", "wo"}
_DENSE_SMOKE = _ATTN | {"w_up", "w_down", "w_gate"}
# (arch, smoke) -> the matrices whose float32 forward takes csrc/mpo_linear.cu
# in both orientations (every other one takes csrc/mpo_linear_mma.cu), and
# those that take it in the i/j-swapped orientation (dL/dx) alone
CUDA_CORE = {
    ("albert-base", True): ({"w_up", "w_down"} | _ATTN, set()),
    ("bert-base", True): ({"w_up", "w_down"} | _ATTN, set()),
    ("gemma2-27b", False): ({"w_up", "w_down", "w_gate"}, set()),
    ("gemma2-27b", True): (_DENSE_SMOKE, set()),
    ("llama4-maverick-400b-a17b", False): ({"embed", "embed_T"}, set()),
    ("llama4-maverick-400b-a17b", True): (
        _ATTN | {"experts/w_up", "experts/w_down", "experts/w_gate"}, set()),
    ("llava-next-34b", False): ({"embed", "embed_T", "lm_head", "w_up", "w_down", "w_gate"}, set()),
    ("llava-next-34b", True): (_DENSE_SMOKE, set()),
    ("mistral-nemo-12b", False): ({"embed", "embed_T", "lm_head"}, set()),
    ("mistral-nemo-12b", True): (_DENSE_SMOKE, set()),
    ("nemotron-4-15b", False): ({"w_up", "w_down"}, set()),
    ("nemotron-4-15b", True): ({"w_up", "w_down"} | _ATTN, set()),
    ("phi3.5-moe-42b-a6.6b", False): ({"embed", "embed_T", "lm_head"}, set()),
    ("phi3.5-moe-42b-a6.6b", True): (
        _ATTN | {"experts/w_up", "experts/w_down", "experts/w_gate"}, set()),
    ("qwen3-14b", False): ({"lm_head"}, set()),
    ("qwen3-14b", True): (_DENSE_SMOKE, set()),
    ("whisper-tiny", False): ({"w_up", "w_down"} | _ATTN, set()),
    ("whisper-tiny", True): ({"w_up", "w_down"} | _ATTN, set()),
    ("zamba2-7b", False): ({"embed", "embed_T"} | _ATTN, {"in_proj"}),
    ("zamba2-7b", True): ({"out_proj", "w_up", "w_down"} | _ATTN, set()),
}
# the float32 matrices whose training gate refuses them (the cores
# backward's plan: no bond's R fits), in both orientations
F32_NO_TRAIN = {("qwen3-14b", False): {"lm_head"}}


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("smoke", [True, False])
def test_float32_route_and_gate_at_every_matrix_of_every_config(arch, smoke):
    """``forward_kernel(..., "float32")`` is ``"cuda_core"`` for exactly the
    pinned matrices, in each orientation; the gate's answers are those it
    gave before the redesign: float32 takes every matrix (in training all
    but ``F32_NO_TRAIN``), bf16 exactly those with a tensor-core route, in
    training those whose both orientations have one."""
    both, swapped_only = CUDA_CORE.get((arch, smoke), (set(), set()))
    no_train = F32_NO_TRAIN.get((arch, smoke), set())
    mats = _matrix_shapes(arch, smoke)
    assert both | swapped_only <= set(mats), (arch, smoke)
    for name, sh in mats.items():
        got = tuple(TMK.forward_kernel(o, "float32") == "cuda_core" for o in (sh, _swap(sh)))
        assert got == (name in both, name in both | swapped_only), (arch, smoke, name)
        for o, narrow in zip((sh, _swap(sh)), got):
            assert TMK.forward_kernel(o, "float32") == ("cuda_core" if narrow else "mma")
            assert TMK.forward_kernel(o, "bfloat16") == (None if narrow else "mma")
            assert TMK.kernel_eligible(o, dtype="float32")
            assert TMK.kernel_eligible(o, dtype="float32", train=True) == (name not in no_train)
            assert TMK.kernel_eligible(o, dtype="bfloat16") == (not narrow)
            assert TMK.kernel_eligible(o, dtype="bfloat16", train=True) == (not any(got))


def _full_width_narrow():
    """{label: core shapes} of every full-width matrix that takes the kernel,
    in the orientation that does."""
    out = {}
    for (arch, smoke), (both, swapped_only) in CUDA_CORE.items():
        if smoke:
            continue
        mats = _matrix_shapes(arch, smoke)
        for name in both | swapped_only:
            if name in both:
                out[f"{arch} {name}"] = mats[name]
            out[f"{arch} {name}^T"] = _swap(mats[name])
    return out


ROWS = (1, 2, 8, 37, 64, 65, 128, 1024, 4352, 12000)


def test_plan_fits_a_block_and_keeps_its_workspace_below_a_quarter_of_w():
    """At every full-width matrix the kernel takes and every row count the
    paths give it: one block's shared memory within ``SMEM_LIMIT``, the
    workspace (the [S, M, J] f32 partials) below a quarter of the bf16 W and
    none above ``S = 1``, whole stages a split, and the bond the same at
    every row count."""
    for label, sh in _full_width_narrow().items():
        i_dim = math.prod(c[1] for c in sh)
        j_dim = math.prod(c[2] for c in sh)
        split = TMK._narrow_split(sh)
        g = TMK._narrow_geometry(sh, split)
        for m in ROWS:
            plan = TMK._narrow_plan(sh, m)
            assert plan.split == split, (label, m)
            assert plan.smem <= TMK.SMEM_LIMIT, (label, m, plan)
            assert plan.lq % g["nq"] == 0
            gl = TMK._narrow_geometry(sh, split, plan.lq // g["nq"])
            assert plan.smem == TMK._narrow_smem_bytes(gl, plan.bm, plan.ch)
            assert plan.rg >= 1 and 1 <= plan.ch <= g["nst"]
            assert 4 * plan.workspace < 2 * i_dim * j_dim, (label, m, plan)
            assert (plan.workspace > 0) == (plan.splits > 1)
            per = -(-g["nst"] // plan.splits)
            assert (plan.splits - 1) * per < g["nst"], (label, m, plan)
            assert plan.bm in TMK.NARROW_BM and (m > 64 or plan.bm == 64)
            # one row tile keeps its sums in registers over one stage of W at a time
            if m <= plan.bm:
                assert (plan.rg, plan.ch) == (1, 1)
            else:
                assert plan.splits == 1


def test_plan_splits_fill_two_waves_at_few_rows():
    """M <= 64: at least as many splits of I as fill two waves of the
    card's 132 SMs with the tiles, unless the stages or the workspace's
    quarter-of-W cap stop them first, in whole stages (each split ``ceil(nst
    / S)`` of them); where the stages are many, the blocks fill the two
    waves.  Above two waves of tiles there is no split."""
    for label, sh in _full_width_narrow().items():
        i_dim = math.prod(c[1] for c in sh)
        g = TMK._narrow_geometry(sh, TMK._narrow_split(sh))
        nst = g["nst"]
        for m in (1, 2, 8, 16, 64):
            plan = TMK._narrow_plan(sh, m)
            tiles = g["jtiles"] * -(-m // plan.bm)
            if tiles >= 2 * TMK.MMA_SMS:
                assert plan.splits == 1, (label, m)
                continue
            cap = min(nst, max(1, -(-i_dim // (8 * m)) - 1))
            floor = min(cap, -(-2 * TMK.MMA_SMS // tiles))
            assert -(-nst // -(-nst // floor)) <= plan.splits <= cap, (label, m, plan)
            assert plan.splits == -(-nst // -(-nst // plan.splits))       # whole stages
            if floor == -(-2 * TMK.MMA_SMS // tiles) and nst >= 4 * floor:
                assert tiles * plan.splits >= 2 * TMK.MMA_SMS, (label, m, plan)
    # the cases chip_smoke times: gemma2-27b's w_down at 64 rows and
    # qwen3-14b's lm_head at a decode step's 2 fill the card
    gemma = _matrix_shapes("gemma2-27b", False)["w_down"]
    plan = TMK._narrow_plan(gemma, 64)
    assert plan.splits > 1
    assert TMK._narrow_geometry(gemma, plan.split)["jtiles"] * plan.splits >= 2 * TMK.MMA_SMS
    qwen = _matrix_shapes("qwen3-14b", False)["lm_head"]
    assert TMK._narrow_geometry(qwen, TMK._narrow_split(qwen))["jtiles"] >= 2 * TMK.MMA_SMS


def test_plan_refuses_what_the_kernel_cannot_take():
    assert TMK._narrow_split(((1, 64, 64, 1),)) is None                    # one core
    assert TMK._narrow_split(((1, 4, 4, 8),) * 9) is None                  # > 8 cores
    assert TMK._narrow_split(((1, 4, 4, 8), (4, 4, 4, 1))) is None         # broken chain
    assert TMK._narrow_split(((1, 64, 64, 2048), (2048, 64, 64, 1))) is None   # R never fits
    assert TMK._narrow_plan(((1, 64, 64, 2048), (2048, 64, 64, 1)), 8) is None


def _chain(cores):
    """The contraction of a run of cores: (d_first, I_run, J_run, d_last),
    digits row-major, float64."""
    t = cores[0]
    for c in cores[1:]:
        a, i, j, _ = t.shape
        _, i2, j2, b = c.shape
        t = torch.einsum("aijr,rklb->aikjlb", t, c).reshape(a, i * i2, j * j2, b)
    return t


def _group_l(p, c_last, g, fi, fo, ip_n, jp_n, ipg0, jpa):
    """``build_l`` of the CUDA source for the L group from ip ``ipg0`` and
    the tile from jp ``jpa``: the products over core s-1's rows with rows
    the (ipp, jpp) pairs and columns the (ik, jk, d) it takes (every ik, or
    the group's in one ipp, or one product a run of ip within one ipp; every
    jk, or the tile's in one jpp), each output placed at its (ip, jq).
    Checks that every entry of the group's L is written once (or zeroed
    past the matrix's edge) and that the P rows it reads are within the
    plan's npp / npq.  Returns L as [lq, ds, njq]."""
    lq, ds, njq = g["lq"], g["ds"], g["njq"]
    lt = torch.full((lq, ds, njq), float("nan"), dtype=torch.float64)
    for q in range(lq):
        for jq in range(njq):
            if ipg0 + q >= ip_n or jpa + jq >= jp_n:
                lt[q, :, jq] = 0.0
    ipg1 = min(ipg0 + lq, ip_n)
    ippa, jppa = ipg0 // fi, jpa // fo
    nipp = (ipg1 - 1) // fi - ippa + 1
    jlast = min(jpa + njq, jp_n) - 1
    npq = jlast // fo - jppa + 1
    assert nipp <= g["npp"] and npq <= g["npq"]
    jk0, njk = (jpa % fo, jlast - jpa + 1) if npq == 1 else (0, fo)

    def product(pp0, npr, ik0, nik):
        for pp in range(pp0, pp0 + npr):
            for pq in range(npq):
                for ik in range(ik0, ik0 + nik):
                    for jk in range(jk0, jk0 + njk):
                        ip = (ippa + pp) * fi + ik
                        jp = (jppa + pq) * fo + jk
                        jq = jp - jpa
                        if ipg0 <= ip < ipg1 and 0 <= jq < njq and jp <= jlast:
                            assert lt[ip - ipg0, :, jq].isnan().all()
                            lt[ip - ipg0, :, jq] = p[ippa + pp, jppa + pq] @ c_last[:, ik, jk, :]

    if nipp == 1 or nipp * fi <= 2 * (ipg1 - ipg0):
        product(0, nipp, ipg0 % fi if nipp == 1 else 0, ipg1 - ipg0 if nipp == 1 else fi)
    else:
        ip = ipg0
        while ip < ipg1:
            nik = min(fi - ip % fi, ipg1 - ip)
            product(ip // fi - ippa, 1, ip % fi, nik)
            ip += nik
    assert not lt.isnan().any()
    return lt


def _replay(cores, x, split, groups=1):
    """The kernel's walk in float64 on the CPU: for every column tile and
    stage, the tile's jp and js window and the stage's ip and is window at
    the padded pitches, P for the L group's ipp and the tile's jpp (checked
    against the plan's npp / npq bounds), the group's L (``_group_l``), R
    padded with zeros, the W stage, the x stage with its padded rows zeroed,
    the product, and the epilogue's column mask.  Returns (W as the stages
    wrote it, y)."""
    shapes = tuple(tuple(c.shape) for c in cores)
    g = TMK._narrow_geometry(shapes, split, groups)
    bk, bn = TMK.NARROW_BK, TMK.NARROW_BN
    i_dim = math.prod(c[1] for c in shapes)
    j_dim = math.prod(c[2] for c in shapes)
    i_s, j_s, isp, jsp, nq, njq = (g[k] for k in ("i_s", "j_s", "isp", "jsp", "nq", "njq"))
    ip_n, jp_n = i_dim // i_s, j_dim // j_s
    isb, jsb = min(isp, bk), min(jsp, bn)
    fi, fo = shapes[split - 1][1], shapes[split - 1][2]
    r = _chain(cores[split:])[..., 0]                                   # (ds, Is, Js)
    rp = torch.zeros(g["ds"], jsp, isp, dtype=torch.float64)
    rp[:, :j_s, :i_s] = r.transpose(1, 2)
    if split == 1:
        p = torch.ones(1, 1, 1, dtype=torch.float64)
    else:
        p = _chain(cores[:split - 1])[0]                               # (Ipp, Jpp, dpre)
    c_last = cores[split - 1]
    if split == 1:                       # P = [1]: the digits index core 0 alone
        fi, fo = ip_n, jp_n
    w_seen = torch.full((i_dim, j_dim), float("nan"), dtype=torch.float64)
    y = torch.zeros(x.shape[0], j_dim, dtype=torch.float64)
    for ct in range(g["jtiles"]):
        jpa = ct * njq if jsp <= bn else ct * bn // jsp
        jsoff = 0 if jsp <= bn else ct * bn % jsp
        ipg0, lgroup = None, None
        for st in range(g["nst"]):
            ipa = st * nq if isp <= bk else st * bk // isp
            isoff = 0 if isp <= bk else st * bk % isp
            if ipg0 is None or not ipg0 <= ipa < ipg0 + g["lq"]:
                ipg0 = ipa // g["lq"] * g["lq"]
                lgroup = _group_l(p, c_last, g, fi, fo, ip_n, jp_n, ipg0, jpa)
            lt = lgroup[ipa - ipg0:ipa - ipg0 + nq]
            kk, cc = torch.arange(bk)[:, None], torch.arange(bn)[None, :]
            q, isx = kk // isb, isoff + kk % isb
            jq, jsx = cc // jsb, jsoff + cc % jsb
            w = (lt[q, :, jq] * rp[:, jsx, isx].permute(1, 2, 0)).sum(-1)   # (bk, bn)
            rho = st * bk + torch.arange(bk)
            ipr, isr = rho // isp, rho % isp
            rok = (ipr < ip_n) & (isr < i_s)
            rows = (ipr * i_s + isr)[rok]
            xs = torch.zeros(x.shape[0], bk, dtype=torch.float64)
            xs[:, rok] = x[:, rows]
            jpc, jsc = jpa + torch.arange(bn) // jsb, jsoff + torch.arange(bn) % jsb
            cok = (jpc < jp_n) & (jsc < j_s)
            cols = (jpc * j_s + jsc)[cok]
            # a padded row or column of W is zero, so the x stage's zeros
            # and the epilogue's mask lose nothing
            assert not w[~rok].any() and not w[:, ~cok].any()
            assert w_seen[rows][:, cols].isnan().all()            # each value once
            w_seen[rows[:, None], cols[None, :]] = w[rok][:, cok]
            y[:, cols] += (xs @ w)[:, cok]
    return w_seen, y


REPLAY_SHAPES = {
    # smoke bert-base's wk: Is and Js 2 .. 16 at the four bonds
    "smoke wk": ((1, 4, 2, 8), (8, 2, 2, 8), (8, 2, 2, 8), (8, 2, 2, 4), (4, 2, 2, 1)),
    # whisper-tiny's attention digits (3 and 9 padded to 4 and 16), narrower bonds
    "whisper-like": ((1, 3, 3, 9), (9, 4, 4, 8), (8, 4, 4, 4), (4, 2, 2, 1)),
    # a js group of 6 (qwen3-14b's lm_head at bond 4) and an is group of 5
    "js 6": ((1, 5, 4, 8), (8, 4, 6, 8), (8, 5, 6, 1)),
    # Is = 40 and Js = 81: groups past a stage (32 rows) and a tile (64 columns)
    "wide groups": ((1, 3, 2, 4), (4, 5, 9, 4), (4, 8, 9, 1)),
    # Is = 1 past bond 2 (zamba2-7b's in_proj^T): stages of 32 ip, no padding
    "is 1": ((1, 7, 6, 8), (8, 9, 8, 8), (8, 1, 4, 4), (4, 1, 4, 1)),
    # one ip a stage (Is = 32) and 6 ik an ipp: an L group of 4 ip straddles
    # two ipp, so L is formed a run of ip at a time
    "ipp runs": ((1, 2, 2, 4), (4, 6, 2, 4), (4, 32, 3, 1)),
}


@pytest.mark.parametrize("name", sorted(REPLAY_SHAPES))
def test_replay_of_the_kernels_walk_rebuilds_w_and_the_product(name):
    """Every bond of each shape and L groups of 1, 2 and 4 stages: the
    stages and tiles cover each value of W once, equal to
    ``mpo.reconstruct``'s, and the product equals x @ W."""
    shapes = REPLAY_SHAPES[name]
    rng = np.random.default_rng(0)
    cores = [torch.from_numpy(rng.standard_normal(s)) for s in shapes]
    i_dim = math.prod(c[1] for c in shapes)
    x = torch.from_numpy(rng.standard_normal((5, i_dim)))
    ref = TM.reconstruct(cores)
    for split in range(1, len(shapes)):
        for groups in (1, 2, 4):           # L groups of 1, 2 and 4 stages' ip
            w, y = _replay(cores, x, split, groups)
            assert not w.isnan().any(), (name, split, groups)
            torch.testing.assert_close(w, ref, rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(y, x @ ref, rtol=1e-10, atol=1e-10)
    assert TMK._narrow_split(shapes) is not None

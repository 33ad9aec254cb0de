"""The port's kernel modules against the JAX package's Pallas kernels (run
in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_decode_attention.py`` run them) and their jnp oracles.

On the CPU each wrapper takes its plain version, so these tests hold the
plain versions and the wrappers' dispatch; the CUDA kernels themselves are
held against the plain versions by the ``test_cuda_*`` tests here (skipped
without a card) and by ``chip_smoke.py`` on the card.

Tolerances: float32 results summed in another order agree to ~1e-6
relative (2e-5 allowed, as tests/test_kernels.py allows the Pallas kernel).
bfloat16: the Pallas kernel rounds its running sum to bf16 after every i1
step while the plain version rounds once, so they differ by a few bf16
steps (3e-2 on O(1) values, as tests/test_kernels.py allows).  The SSD scan
rounds y to bf16 once in both, from f32 sums in another order: one bf16
step apart at most (8e-2 allowed on O(1) values, as tests/test_kernels.py
allows the Pallas kernel against its oracle)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mpo as JM
from repro.kernels import decode_attention as JDA
from repro.kernels.mpo_linear import _bwd_cores_call
from repro.kernels.mpo_linear import mpo_linear as j_mpo_linear
from repro.kernels.ref import mpo_linear_ref
from repro.kernels.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.kernels.ssd_scan import ssd_scan as j_ssd_scan
from repro_torch import configs
from repro_torch.core import mpo as TM
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import model as TModel

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _bf16_np(x: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(run these on the H100 with `python -m pytest -q "
                    "tests/test_torch_kernels.py -k cuda`)")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# MPO-linear
# --------------------------------------------------------------------------


def _mpo_inputs(dims, n, bond, m, seed=0):
    spec = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(seed)
    bonds = math.prod(spec.bonds()) if n > 1 else 1
    sigma = (1.0 / dims[0] / bonds) ** (1.0 / (2 * n))
    cores = [(rng.standard_normal(s) * sigma).astype(np.float32)
             for s in spec.core_shapes()]
    x = rng.standard_normal((m, dims[0])).astype(np.float32)
    return cores, x


@pytest.mark.parametrize("dims,n,bond", [
    ((24, 36), 3, None), ((64, 96), 3, 8), ((64, 64), 5, 8),
    ((512, 1024), 5, 16), ((128, 48), 4, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mpo_linear_plain_matches_pallas_and_ref(dims, n, bond, dtype):
    cores, x = _mpo_inputs(dims, n, bond, 37)
    if dtype == "bfloat16":
        cores, x = [_bf16_np(c) for c in cores], _bf16_np(x)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jc = tuple(jnp.asarray(c, jdt) for c in cores)
    jx = jnp.asarray(x, jdt)
    y_pallas = np.asarray(j_mpo_linear(jc, jx, block_m=16, interpret=True), np.float32)
    y_ref = np.asarray(mpo_linear_ref(list(jc), jx), np.float32)
    calls = TMK.mpo_linear_plain.calls
    y = TMK.mpo_linear([torch.from_numpy(c).to(tdt) for c in cores],
                       torch.from_numpy(x).to(tdt))
    assert TMK.mpo_linear_plain.calls == calls + 1      # CPU -> plain version
    assert y.dtype == tdt and tuple(y.shape) == (37, dims[1])
    for ref in (y_pallas, y_ref):
        np.testing.assert_allclose(y.float().numpy(), ref, atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_mpo_linear_plain_keeps_lead_dims():
    cores, x = _mpo_inputs((32, 48), 3, 4, 15)
    y = TMK.mpo_linear([torch.from_numpy(c) for c in cores],
                       torch.from_numpy(x).reshape(3, 5, 32))
    ref = mpo_linear_ref([jnp.asarray(c) for c in cores], jnp.asarray(x))
    assert tuple(y.shape) == (3, 5, 48)
    np.testing.assert_allclose(y.reshape(15, 48).numpy(), np.asarray(ref), atol=2e-5)


def _bert_matrix_shapes():
    """Core shapes of every factorized matrix of full-width bert-base, as the
    port initializes them (abstractly: no weights are drawn)."""
    cfg = configs.get_config("bert-base")
    with torch.device("meta"):
        params = TModel.transformer.init(torch.Generator(), cfg)
    from repro_torch.core.layers import cores_to_list
    out = {"embed": [tuple(c.shape) for c in cores_to_list(params["embed"]["cores"])]}
    for grp in ("attn", "mlp"):
        for name, lin in params["layers"][grp].items():
            out[name] = [tuple(c.shape[1:]) for c in cores_to_list(lin["cores"])]
    return out


def test_hopper_gate_admits_every_bert_base_matrix():
    shapes = _bert_matrix_shapes()
    assert set(shapes) == {"embed", "wq", "wk", "wv", "wo", "w_up", "w_down"}
    for name, s in shapes.items():
        t = [(d0, j, i, d1) for d0, i, j, d1 in s]      # tied logits: W^T
        for sh in (s, t):
            for dtype in ("float32", "bfloat16"):
                assert TMK.kernel_eligible(sh, dtype=dtype), (name, sh)
            for m in (1, 8, 64, 128, 2048):          # every row tile of the float32 plan
                plan = TMK._narrow_plan(tuple(sh), m)
                assert plan.smem <= TMK.SMEM_LIMIT, (name, m, plan)
            # training: dL/dx over W^T and the cores backward fit too; no
            # float16 kernel
            assert TMK.kernel_eligible(sh, train=True, dtype="bfloat16")
            assert TMK._bwd_plan(tuple(sh)).smem <= TMK.SMEM_LIMIT
            assert not TMK.kernel_eligible(sh, dtype="float16")


def test_hopper_gate_admits_mamba2_matrices():
    """mamba2-130m's in_proj (768 -> 3352, out factors (419, 2, 2, 2, 1)),
    out_proj (1536 -> 768) and tied head: both orientations fit the float32
    forward's (``csrc/mpo_linear.cu``) shared memory at every row tile, and
    the backward too."""
    from repro_torch.core.layers import cores_to_list
    from repro_torch.models import mamba as TMB
    with torch.device("meta"):
        params = TMB.init(torch.Generator(), configs.get_config("mamba2-130m"))
    mats = {name: [tuple(c.shape[1:]) for c in cores_to_list(params["layers"][name]["cores"])]
            for name in ("in_proj", "out_proj")}
    mats["embed"] = [tuple(c.shape) for c in cores_to_list(params["embed"]["cores"])]
    assert mats["in_proj"][0] == (1, 3, 419, 64)
    for name, s in mats.items():
        t = [(d0, j, i, d1) for d0, i, j, d1 in s]
        for sh in (s, t):
            assert TMK.kernel_eligible(sh, dtype="bfloat16", train=True), (name, sh)
            for m in (1, 8, 64, 128, 2048):
                plan = TMK._narrow_plan(tuple(sh), m)
                assert plan.smem <= TMK.SMEM_LIMIT, (name, m, plan)


def test_hopper_gate_refuses_what_the_kernel_cannot_take():
    assert not TMK.kernel_eligible([(1, 64, 64, 1)])                  # one core
    assert not TMK.kernel_eligible([(1, 4, 4, 8)] * 9)                # > 8 cores
    assert not TMK.kernel_eligible([(1, 4, 4, 8), (4, 4, 4, 1)])      # broken chain
    # every bond's suffix contraction too large for shared memory
    assert not TMK.kernel_eligible([(1, 64, 64, 2048), (2048, 64, 64, 1)])


def test_mpo_linear_rejects_other_devices():
    cores, x = _mpo_inputs((24, 36), 3, None, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        TMK.mpo_linear([torch.from_numpy(c).to("meta") for c in cores],
                       torch.from_numpy(x).to("meta"))


@pytest.mark.cuda
def test_cuda_mpo_linear_matches_plain(cuda):
    """Every bert-base matrix in both dtypes (the tensor-core kernel), and
    smoke bert-base's attention matrix, whose float32 shapes keep the
    CUDA-core kernel."""
    mats = _bert_matrix_shapes()
    del mats["embed"]
    with torch.device("meta"):
        smoke = TModel.transformer.init(torch.Generator(), configs.smoke_config("bert-base"))
    from repro_torch.core.layers import cores_to_list
    mats["smoke wq"] = [tuple(c.shape[1:]) for c in cores_to_list(
        smoke["layers"]["attn"]["wq"]["cores"])]
    for name, s in mats.items():
        rng = np.random.default_rng(0)
        cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32))
                 for c in s]
        for m in (8, 37, 1024):
            x = torch.from_numpy(rng.standard_normal((m, cores[0].shape[1] * math.prod(
                c.shape[1] for c in cores[1:]))).astype(np.float32))
            for dtype in (torch.float32, torch.bfloat16):
                route = TMK.forward_kernel(s, str(dtype).split(".")[1])
                if route is None:
                    continue                     # smoke shapes: no bf16 kernel
                assert route == ("cuda_core" if name == "smoke wq" else "mma")
                cs = [c.to(cuda, dtype) for c in cores]
                xx = x.to(cuda, dtype)
                counter = TMK.mpo_linear_mma if route == "mma" else TMK.mpo_linear_cuda_core
                launches = counter.launches
                y = TMK.mpo_linear(cs, xx)
                torch.cuda.synchronize()
                assert counter.launches == launches + 1
                ref = TMK.mpo_linear_plain(cs, xx).float()
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                assert (y.float() - ref).abs().max() <= tol * ref.abs().max()


# --------------------------------------------------------------------------
# MPO-linear cores backward
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dims,n,bond,m", [
    ((24, 36), 3, None, 37), ((64, 96), 3, 8, 19), ((64, 64), 5, 8, 16),
    ((128, 48), 4, 6, 5)])                # tests/test_kernel_vjp.py's shapes
def test_mpo_linear_bwd_cores_plain_matches_pallas_and_grad(dims, n, bond, m):
    """The plain cores-backward against the reference's ``_bwd_cores_call``
    (interpret mode, non-aligned M padded by it) and against ``jax.grad`` of
    ``sum(dy * mpo_linear_ref(cores, x))``; float32, 2e-5 relative."""
    cores, x = _mpo_inputs(dims, n, bond, m)
    dy = np.random.default_rng(9).standard_normal((m, dims[1])).astype(np.float32)
    jc = [jnp.asarray(c) for c in cores]
    pallas = _bwd_cores_call(jc, jnp.asarray(x), jnp.asarray(dy), 16, True)
    grad = jax.grad(lambda cs: jnp.sum(mpo_linear_ref(list(cs), jnp.asarray(x)) * dy))(
        tuple(jc))
    calls = TMK.mpo_linear_bwd_cores_plain.calls
    got = TMK.mpo_linear_bwd_cores([torch.from_numpy(c) for c in cores],
                                   torch.from_numpy(x), torch.from_numpy(dy))
    assert TMK.mpo_linear_bwd_cores_plain.calls == calls + 1    # CPU -> plain version
    for k, g in enumerate(got):
        assert g.dtype == torch.float32 and tuple(g.shape) == cores[k].shape
        for ref in (pallas[k], grad[k]):
            ref = np.asarray(ref)
            np.testing.assert_allclose(g.numpy(), ref, rtol=TOL["float32"],
                                       atol=TOL["float32"] * np.abs(ref).max())
    # only the cores asked for
    some = TMK.mpo_linear_bwd_cores([torch.from_numpy(c) for c in cores], torch.from_numpy(x),
                                    torch.from_numpy(dy), needs=[k % 2 == 0 for k in range(n)])
    assert [g is None for g in some] == [k % 2 == 1 for k in range(n)]
    torch.testing.assert_close(some[0], got[0])


def test_bwd_plan_refuses_and_blocks_stay_bounded():
    assert TMK._bwd_plan(((1, 64, 64, 1),)) is None                   # one core
    assert TMK._bwd_plan(((1, 4, 4, 8), (4, 4, 4, 1))) is None         # broken chain
    # the only bond's R is 2 x 128 x 128 (above BWD_RMAX) and d_s = 2 not a
    # multiple of 4
    assert TMK._bwd_plan(((1, 128, 128, 2), (2, 128, 128, 1))) is None
    assert not TMK.kernel_eligible([(1, 128, 128, 2), (2, 128, 128, 1)], train=True)
    for name, s in _bert_matrix_shapes().items():
        if name == "embed":
            continue
        for sms in (132, 114, 8):
            nb = TMK._bwd_plan(tuple(s), "bfloat16", sms).blocks
            assert 1 <= nb <= sms, (name, sms, nb)


def test_mpo_linear_bwd_cores_rejects_other_devices():
    cores, x = _mpo_inputs((24, 36), 3, None, 4)
    dy = np.zeros((4, 36), np.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        TMK.mpo_linear_bwd_cores([torch.from_numpy(c).to("meta") for c in cores],
                                 torch.from_numpy(x).to("meta"), torch.from_numpy(dy).to("meta"))


@pytest.mark.cuda
def test_cuda_mpo_linear_bwd_cores_matches_plain(cuda):
    """The CUDA cores-backward against its plain version at every bert-base
    attention/FFN shape, ragged and training M, both dtypes, and two runs
    bit-identical (no atomics); its scratch below an f32 dW; a call with the
    central core skipped (``freeze_central_grads``) gives the other cores
    the same bits."""
    for name, s in _bert_matrix_shapes().items():
        if name == "embed":
            continue
        rng = np.random.default_rng(0)
        cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32))
                 for c in s]
        i_dim = math.prod(c[1] for c in s)
        j_dim = math.prod(c[2] for c in s)
        for m in (37, 2048):
            x = torch.from_numpy(rng.standard_normal((m, i_dim)).astype(np.float32))
            dy = torch.from_numpy(rng.standard_normal((m, j_dim)).astype(np.float32))
            for dtype in (torch.float32, torch.bfloat16):
                cs = [c.to(cuda, dtype) for c in cores]
                xx, dd = x.to(cuda, dtype), dy.to(cuda, dtype)
                launches = TMK.mpo_linear_bwd_cores.launches
                got = TMK.mpo_linear_bwd_cores(cs, xx, dd)
                again = TMK.mpo_linear_bwd_cores(cs, xx, dd)
                torch.cuda.synchronize()
                assert TMK.mpo_linear_bwd_cores.launches == launches + 2
                assert all(torch.equal(a, b) for a, b in zip(got, again))
                assert TMK.mpo_linear_bwd_cores.workspace_bytes < 4 * i_dim * j_dim
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                for g, r in zip(got, TMK.mpo_linear_bwd_cores_plain(cs, xx, dd)):
                    r = r.float()
                    assert (g.float() - r).abs().max() <= tol * r.abs().max(), (name, m, dtype)
                central = len(cs) // 2
                some = TMK.mpo_linear_bwd_cores(cs, xx, dd, [k != central for k in range(len(cs))])
                assert some[central] is None
                assert all(torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got))
                           if k != central)


@pytest.mark.cuda
def test_cuda_mpo_linear_bwd_cores_other_shapes(cuda):
    """The cores backward on the card at ``tests/test_kernel_vjp.py``'s
    four shapes (I or J not a multiple of 8: element loads instead of
    cp.async; splits at the first and the last bond; ragged tiles; clusters
    of one and two) and at mamba2-130m's in_proj and out_proj in both
    orientations (128 x 128 tiles, Is = 64 or Js = 4), both dtypes, against
    the plain version, two launches bit-identical."""
    from repro_torch.core.layers import cores_to_list
    from repro_torch.models import mamba as TMB
    with torch.device("meta"):
        mamba = TMB.init(torch.Generator(), configs.get_config("mamba2-130m"))
    cases = [[tuple(c) for c in JM.MPOSpec.make(*dims, n=n, bond_dim=bond).core_shapes()]
             for dims, n, bond in [((24, 36), 3, None), ((64, 96), 3, 8), ((64, 64), 5, 8),
                                   ((128, 48), 4, 6)]]
    for name in ("in_proj", "out_proj"):
        s = [tuple(c.shape[1:]) for c in cores_to_list(mamba["layers"][name]["cores"])]
        cases += [s, [(d0, j, i, d1) for d0, i, j, d1 in s]]
    rng = np.random.default_rng(0)
    for s in cases:
        cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32)) for c in s]
        i_dim = math.prod(c[1] for c in s)
        j_dim = math.prod(c[2] for c in s)
        x = torch.from_numpy(rng.standard_normal((37, i_dim)).astype(np.float32))
        dy = torch.from_numpy(rng.standard_normal((37, j_dim)).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            cs = [c.to(cuda, dtype) for c in cores]
            xx, dd = x.to(cuda, dtype), dy.to(cuda, dtype)
            got = TMK.mpo_linear_bwd_cores(cs, xx, dd)
            again = TMK.mpo_linear_bwd_cores(cs, xx, dd)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (s, dtype)
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            for g, r in zip(got, TMK.mpo_linear_bwd_cores_plain(cs, xx, dd)):
                r = r.float()
                assert (g.float() - r).abs().max() <= tol * r.abs().max(), (s, dtype)


def _squeezed_shapes():
    """bert-base matrices with one bond truncated as Algorithm 2 leaves it:
    odd bonds 63 (attn's split bond s = 3, w_down's bond 1), 39 (the
    embedding's bond 1), 15 (w_up's last bond) and 17 (w_down's first)."""
    mats = _bert_matrix_shapes()

    def cut(name, k, new):
        s = [list(c) for c in mats[name]]
        s[k][3] = s[k + 1][0] = new
        return [tuple(c) for c in s]

    return {"attn bond 2 = 63": cut("wq", 2, 63), "w_down bond 1 = 63": cut("w_down", 1, 63),
            "embed bond 1 = 39": cut("embed", 1, 39), "w_up bond 3 = 15": cut("w_up", 3, 15),
            "w_down bond 0 = 17": cut("w_down", 0, 17)}


def test_plans_take_the_squeezed_bonds():
    """Both kernels' plans take every squeezed shape in both orientations
    (the engine would send them to ``reconstruct`` otherwise)."""
    for name, s in _squeezed_shapes().items():
        t = [(d0, j, i, d1) for d0, i, j, d1 in s]
        for dtype in ("float32", "bfloat16"):
            assert TMK.forward_kernel(s, dtype) == TMK.forward_kernel(t, dtype) == "mma", name
            assert TMK.kernel_eligible(s, dtype=dtype, train=True), name


@pytest.mark.cuda
def test_cuda_mpo_linear_at_squeezed_bonds(cuda):
    """The forward (over W and W^T) and the cores backward at the odd bonds
    squeezing leaves, both dtypes, M = 37 and 2048, against the plain
    versions; two launches bit-identical.  Tolerances are ``chip_smoke.py``'s
    ``TOL``, the embedding's W (a sum over I = 30720) included."""
    for name, s in _squeezed_shapes().items():
        rng = np.random.default_rng(0)
        cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32))
                 for c in s]
        i_dim = math.prod(c[1] for c in s)
        j_dim = math.prod(c[2] for c in s)
        for m in (37, 2048):
            x = torch.from_numpy(rng.standard_normal((m, i_dim)).astype(np.float32))
            dy = torch.from_numpy(rng.standard_normal((m, j_dim)).astype(np.float32))
            for dtype in (torch.float32, torch.bfloat16):
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                cs = [c.to(cuda, dtype) for c in cores]
                xx, dd = x.to(cuda, dtype), dy.to(cuda, dtype)
                for form, ws, inp in (("W", cs, xx), ("W^T", TM.transpose_cores(cs), dd)):
                    ws = [w.contiguous() for w in ws]
                    y, again = TMK.mpo_linear(ws, inp), TMK.mpo_linear(ws, inp)
                    torch.cuda.synchronize()
                    assert torch.equal(y, again), (name, form, m, dtype)
                    ref = TMK.mpo_linear_plain(ws, inp).float()
                    assert (y.float() - ref).abs().max() <= tol * ref.abs().max(), (
                        name, form, m, dtype)
                got = TMK.mpo_linear_bwd_cores(cs, xx, dd)
                again = TMK.mpo_linear_bwd_cores(cs, xx, dd)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, again)), (name, m, dtype)
                for g, r in zip(got, TMK.mpo_linear_bwd_cores_plain(cs, xx, dd)):
                    r = r.float()
                    assert (g.float() - r).abs().max() <= tol * r.abs().max(), (name, m, dtype)


# --------------------------------------------------------------------------
# flash decode attention
# --------------------------------------------------------------------------


def _paged_inputs(b, kv, g, dh, ps, mp, lens, seed=0):
    rng = np.random.default_rng(seed)
    p = b * mp
    q = rng.standard_normal((b, kv, g, dh)).astype(np.float32)
    kp = rng.standard_normal((p, ps, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((p, ps, kv, dh)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    need = (lens + ps - 1) // ps
    perm = rng.permutation(p).astype(np.int32).reshape(b, mp)
    table = np.where(np.arange(mp)[None] < need[:, None], perm, -1).astype(np.int32)
    bias = np.where(np.arange(mp * ps)[None] < lens[:, None], 0.0,
                    TDA.MASK_VALUE).astype(np.float32)
    return q, kp, vp, table, lens, bias


CASES = [  # (kv, g, dh, ps, mp, lens, softcap)
    (2, 2, 16, 4, 3, [12, 5, 1], None),            # GQA, ragged
    (1, 4, 8, 4, 3, [0, 7, 12], None),             # MQA, an idle (zero-length) slot
    (4, 1, 16, 4, 2, [3, 0, 8], None),             # MHA
    (2, 3, 8, 4, 3, [9, 12, 2], 5.0),              # softcap
    (3, 2, 16, 8, 2, [16, 1, 0], 2.0),             # softcap + idle + one key
]


@pytest.mark.parametrize("kv,g,dh,ps,mp,lens,softcap", CASES)
def test_flash_plain_matches_pallas(kv, g, dh, ps, mp, lens, softcap):
    args = _paged_inputs(3, kv, g, dh, ps, mp, lens)
    ref = np.asarray(JDA.flash_decode_attention(*[jnp.asarray(a) for a in args],
                                                softcap=softcap, interpret=True))
    calls = TDA.flash_decode_attention_plain.calls
    out = TDA.flash_decode_attention(*[torch.from_numpy(a) for a in args],
                                     softcap=softcap)
    assert TDA.flash_decode_attention_plain.calls == calls + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    # an idle slot's output is exactly zero, as the kernel's _TINY guard gives
    for i, n in enumerate(lens):
        if n == 0:
            assert not out[i].any()


def test_gather_pages_matches_and_clamps():
    rng = np.random.default_rng(0)
    pages = rng.standard_normal((6, 4, 2, 3)).astype(np.float32)
    table = np.array([[2, -1, 5], [0, 6, 1]], np.int32)   # -1 and P: out of range
    ref = np.asarray(JDA.gather_pages(jnp.asarray(pages), jnp.asarray(table)))
    out = TDA.gather_pages(torch.from_numpy(pages), torch.from_numpy(table))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_flash_rejects_other_devices():
    args = [torch.from_numpy(a).to("meta") for a in _paged_inputs(2, 1, 1, 8, 4, 2, [3, 4])]
    with pytest.raises(ValueError, match="unsupported device"):
        TDA.flash_decode_attention(*args)


@pytest.mark.parametrize("b,kv,g,dh,mp", [
    (8, 12, 1, 64, 16),                  # bert-base serving: 96 (slot, head) pairs
    (8, 8, 5, 128, 16),                  # qwen3-14b geometry
    (64, 12, 1, 64, 16),                 # 768 pairs: 2 splits fill two waves
    (512, 12, 1, 64, 16),                # 6144 pairs already fill the card
    (1, 1, 1, 2048, 16), (1, 1, 256, 8, 2)])   # the largest G * Dh
def test_flash_plan_fills_two_waves_and_gives_every_split_a_page(b, kv, g, dh, mp):
    plan = TDA._flash_plan(b, kv, g, dh, 16, mp)
    waves = 2 * TDA.SMS * TDA.BLOCKS_PER_SM
    assert 1 <= plan.splits <= mp                  # a full slot: a page a split at least
    assert b * kv * plan.splits <= max(waves, b * kv)
    if b * kv >= waves:
        assert plan.splits == 1
    else:
        assert b * kv * (plan.splits + 1) > waves or plan.splits == mp
    # the balanced page ranges of a full slot are never empty
    ranges = [(s * mp // plan.splits, (s + 1) * mp // plan.splits) for s in range(plan.splits)]
    assert all(hi > lo for lo, hi in ranges) and ranges[-1][1] == mp
    # a tile holds a full slot's split (16-key pages), as far as shared memory allows
    assert 1 <= plan.kt <= min(TDA.KT, 16 * max(hi - lo for lo, hi in ranges))
    assert TDA._flash_smem(g, dh, plan.kt, 4) <= TDA.SMEM_LIMIT
    assert plan.workspace == (b * kv * plan.splits * g * (dh + 2) if plan.splits > 1 else 0)
    if g * dh <= 640:
        assert plan.kt == min(TDA.KT, 16 * max(hi - lo for lo, hi in ranges))
    assert (b, kv, plan.splits) != (8, 12, 1)      # bert-base serving splits its slots


@pytest.mark.cuda
def test_cuda_flash_matches_plain(cuda):
    for kv, g, dh, softcap in ((12, 1, 64, None), (8, 5, 128, None), (8, 5, 128, 30.0)):
        args = _paged_inputs(8, kv, g, dh, 16, 16, [0, 1, 17, 128, 129, 200, 255, 256])
        for dtype in (torch.float32, torch.bfloat16):
            t = [torch.from_numpy(a).to(cuda) for a in args]
            t[:3] = [a.to(dtype) for a in t[:3]]
            launches = TDA.flash_decode_attention.launches
            out = TDA.flash_decode_attention(*t, softcap=softcap)
            torch.cuda.synchronize()
            assert TDA.flash_decode_attention.launches == launches + 1
            ref = TDA.flash_decode_attention_plain(*t, softcap=softcap).float()
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
            assert (out.float() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.cuda
def test_cuda_flash_split_boundaries_are_bit_identical(cuda):
    """Lengths at page and split boundaries of the bert-base plan (S = 16
    over 16 pages: a split a page at a full slot, several splits empty on
    shorter slots), and a zero-length slot: within tolerance of the plain
    version, zeros for the idle slot, and two launches give the same bits."""
    lens = [0, 1, 16, 17, 127, 128, 129, 256]
    args = _paged_inputs(8, 12, 1, 64, 16, 16, lens, seed=3)
    assert TDA._flash_plan(8, 12, 1, 64, 16, 16).splits == 16
    for dtype in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(a).to(cuda) for a in args]
        t[:3] = [a.to(dtype) for a in t[:3]]
        out = TDA.flash_decode_attention(*t)
        again = TDA.flash_decode_attention(*t)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert not out[0].any()
        ref = TDA.flash_decode_attention_plain(*t).float()
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        assert (out.float() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv,g,dh,mp", [
    (256, 12, 1, 64, 2),                 # 3072 pairs: one split, no combine pass
    (3, 2, 3, 6, 3),                     # 12-byte bf16 rows: element loads
    (3, 3, 2, 12, 2)])                   # 48-byte f32 rows, 24-byte bf16 rows
def test_cuda_flash_one_split_and_unaligned_rows(cuda, b, kv, g, dh, mp):
    lens = [(7 * i + 5) % (mp * 16 + 1) for i in range(b)]
    args = _paged_inputs(b, kv, g, dh, 16, mp, lens, seed=4)
    if b * kv >= 2 * TDA.SMS * TDA.BLOCKS_PER_SM:
        assert TDA._flash_plan(b, kv, g, dh, 16, mp).splits == 1
    for dtype in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(a).to(cuda) for a in args]
        t[:3] = [a.to(dtype) for a in t[:3]]
        out = TDA.flash_decode_attention(*t, softcap=5.0)
        again = TDA.flash_decode_attention(*t, softcap=5.0)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = TDA.flash_decode_attention_plain(*t, softcap=5.0).float()
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        assert (out.float() - ref).abs().max() <= tol * ref.abs().max(), (b, dh, dtype)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: launches on cuda:1 while cuda:0 is "
                    "current (run on a machine with two cards with `python -m pytest "
                    "-q tests/test_torch_kernels.py -k two_cards`)")
    return torch.device("cuda:1")


@pytest.mark.cuda
def test_cuda_wrappers_launch_on_the_tensors_device_two_cards(two_cards):
    """Each of the five wrappers, given tensors on cuda:1 while cuda:0 is the
    current device, launches there and matches its plain version."""
    dev = two_cards
    torch.cuda.set_device(0)
    mats = _bert_matrix_shapes()
    rng = np.random.default_rng(0)
    wq = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32)).to(dev)
          for c in mats["wq"]]
    with torch.device("meta"):
        smoke = TModel.transformer.init(torch.Generator(), configs.smoke_config("bert-base"))
    from repro_torch.core.layers import cores_to_list
    narrow = [torch.from_numpy((rng.standard_normal(c.shape[1:]) * 0.35).astype(np.float32))
              .to(dev) for c in cores_to_list(smoke["layers"]["attn"]["wq"]["cores"])]
    x = torch.from_numpy(rng.standard_normal((37, 768)).astype(np.float32)).to(dev)
    xn = x[:, :math.prod(c.shape[1] for c in narrow)].contiguous()
    dy = torch.from_numpy(rng.standard_normal((37, 768)).astype(np.float32)).to(dev)
    counts = (TMK.mpo_linear_mma.launches, TMK.mpo_linear_cuda_core.launches,
              TMK.mpo_linear_bwd_cores.launches, TDA.flash_decode_attention.launches,
              TSSD.ssd_scan.launches)
    got = {
        "mma": (TMK.mpo_linear(wq, x), TMK.mpo_linear_plain(wq, x)),
        "cuda_core": (TMK.mpo_linear(narrow, xn), TMK.mpo_linear_plain(narrow, xn)),
        "bwd": (TMK.mpo_linear_bwd_cores(wq, x, dy)[0],
                TMK.mpo_linear_bwd_cores_plain(wq, x, dy)[0]),
    }
    fa = [torch.from_numpy(a).to(dev) for a in _paged_inputs(8, 12, 1, 64, 16, 16,
                                                             [0, 1, 17, 128, 129, 200, 255, 256])]
    got["flash"] = (TDA.flash_decode_attention(*fa), TDA.flash_decode_attention_plain(*fa))
    sa = _ssd_torch(_ssd_inputs(2, 100, 24, 64, 128, seed=1), "float32", dev)
    got["ssd"] = (TSSD.ssd_scan(*sa, 128)[0], TSSD.ssd_scan_plain(*sa, 128)[0])
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    after = (TMK.mpo_linear_mma.launches, TMK.mpo_linear_cuda_core.launches,
             TMK.mpo_linear_bwd_cores.launches, TDA.flash_decode_attention.launches,
             TSSD.ssd_scan.launches)
    assert all(a == b + 1 for a, b in zip(after, counts)), (counts, after)
    for name, (out, ref) in got.items():
        assert out.device == dev, name
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), name



# --------------------------------------------------------------------------
# chunked SSD scan
# --------------------------------------------------------------------------


def _ssd_inputs(b, s, h, p, n, dtype="float32", seed=0):
    """The inputs of tests/test_kernels.py's SSD case, drawn with numpy; in
    bf16, x, dt, B and C are rounded to bf16 values for both sides (the port
    takes dt in f32, the Pallas kernel casts it to f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    d = np.ones(h, np.float32)
    if dtype == "bfloat16":
        x, dt, bm, cm = (_bf16_np(a) for a in (x, dt, bm, cm))
    return x, dt, a_log, bm, cm, d


def _ssd_torch(args, dtype, device="cpu"):
    x, dt, a_log, bm, cm, d = (torch.from_numpy(a).to(device) for a in args)
    tdt = getattr(torch, dtype)
    return x.to(tdt), dt, a_log, bm.to(tdt), cm.to(tdt), d


@pytest.mark.parametrize("shape", [(1, 32, 2, 8, 8), (2, 64, 3, 8, 16), (2, 128, 4, 16, 32)])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_ref(shape, chunk, dtype):
    """The plain version against the Pallas kernel (interpret mode) and its
    sequential oracle, at tests/test_kernels.py's shapes and chunks."""
    args = _ssd_inputs(*shape, dtype=dtype)
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a) for a in args]
    for k in (0, 1, 3, 4):
        jargs[k] = jargs[k].astype(jdt)
    y_pallas = np.asarray(j_ssd_scan(*jargs, chunk=chunk, interpret=True), np.float32)
    y_ref = np.asarray(j_ssd_scan_ref(*jargs), np.float32)
    calls = TSSD.ssd_scan_plain.calls
    y, state = TSSD.ssd_scan(*_ssd_torch(args, dtype), chunk)
    assert TSSD.ssd_scan_plain.calls == calls + 1      # CPU -> plain version
    b, s, h, p, n = shape
    assert y.dtype == getattr(torch, dtype) and tuple(y.shape) == (b, s, h, p)
    assert state.dtype == torch.float32 and tuple(state.shape) == (b, h, n, p)
    tol = 2e-5 if dtype == "float32" else 8e-2
    for ref in (y_pallas, y_ref):
        np.testing.assert_allclose(y.float().numpy(), ref, atol=tol, rtol=tol)


def test_ssd_scan_rejects_what_it_cannot_take():
    args = _ssd_torch(_ssd_inputs(1, 48, 2, 8, 8), "float32")
    with pytest.raises(ValueError, match="not divisible by chunk"):
        TSSD.ssd_scan(*args, 32)                       # q = 32 does not divide 48
    with pytest.raises(ValueError, match="unsupported device"):
        TSSD.ssd_scan(*[a.to("meta") for a in args], 16)
    # what the kernel takes: q <= 128, N <= 128, P <= 64
    TSSD._check(*args, 16)
    for shape, q in (((1, 258, 2, 8, 8), 129), ((1, 48, 2, 8, 129), 16),
                     ((1, 48, 2, 65, 8), 16)):
        big = _ssd_torch(_ssd_inputs(*shape), "float32")
        with pytest.raises(ValueError, match="does not take"):
            TSSD._check(*big, q)


@pytest.mark.cuda
def test_cuda_ssd_scan_matches_plain(cuda):
    """The CUDA kernel against its plain version: the mamba2-130m head
    geometry (H=24, P=64, N=128) at a 4-chunk prompt, a 100-token prompt
    (q = 100), a small case and a ragged one (q = 11, P = 13, N = 5: the
    scalar staging and the one-element state pass), both dtypes; two calls
    give the same bits; y within 1e-4 (f32) or one bf16 step doubled (2^-7)
    of its largest magnitude, the final state within 1e-4 relative."""
    for shape, chunk in (((2, 512, 24, 64, 128), 128), ((2, 100, 24, 64, 128), 128),
                         ((3, 48, 5, 16, 16), 16), ((1, 33, 2, 13, 5), 11)):
        for dtype in ("float32", "bfloat16"):
            args = _ssd_torch(_ssd_inputs(*shape, dtype=dtype, seed=1), dtype, cuda)
            launches = TSSD.ssd_scan.launches
            y, state = TSSD.ssd_scan(*args, chunk)
            again, state_again = TSSD.ssd_scan(*args, chunk)
            torch.cuda.synchronize()
            assert TSSD.ssd_scan.launches == launches + 2
            assert torch.equal(y, again) and torch.equal(state, state_again)
            ry, rstate = TSSD.ssd_scan_plain(*args, chunk)
            tol = 1e-4 if dtype == "float32" else 2.0 ** -7
            assert (y.float() - ry.float()).abs().max() <= tol * ry.float().abs().max()
            assert (state - rstate).abs().max() <= 1e-4 * rstate.abs().max()


@pytest.mark.cuda
def test_cuda_ssd_plan_agrees_with_the_source(cuda):
    """``_ssd_plan``'s cost model against the compiled kernel: launch 3's
    blocks an SM (``_ssd_resident``: registers and shared memory) equal to
    the card's occupancy (``ssd_scan_resident``), and every launch's shared
    memory equal to ``ssd_scan_smem``, at every head group and at the
    corners of what ``_check`` admits, both dtypes."""
    lib = TSSD._lib()
    for q in (1, 16, 100, 128):
        for n in (8, 16, 128):
            for p in (8, 16, 64):
                for dtype, code in (("float32", 0), ("bfloat16", 1)):
                    for g in range(1, TSSD.SSD_GMAX + 1):
                        case = (q, n, p, g, dtype)
                        assert lib.ssd_scan_resident(q, n, p, g, code) == \
                            TSSD._ssd_resident(q, n, p, g, dtype), case
                        assert tuple(lib.ssd_scan_smem(k, q, n, p, g, code)
                                     for k in (1, 2, 3)) == TSSD._ssd_smem(q, n, p, g, dtype), case

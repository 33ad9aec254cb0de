"""The SSD scan's gradients in the port (``repro_torch/kernels/ssd_scan.py``:
``ssd_scan_bwd_plain``, ``SSDScanFn``, ``_ssd_bwd_plan``) against ``jax.grad``
of the reference's ``ssd_chunked``, and the ssm family's LFA split at full
width.

The backward kernel (``csrc/ssd_scan_bwd.cu``) runs only on the card; its
plain version here writes out the same chunked formulas (the reverse pass
over the carried states, the two sides of each chunk's diagonal, the
reverse cumulative sum of d(dac)), and ``SSDScanFn`` on CPU tensors runs
it as the autograd backward.  Inputs are drawn with numpy at a seed, at the
smoke mamba2-130m's head geometry (8 heads of 16, state 16, chunk 16).

Tolerances: float32, the two frameworks sum in other orders (1e-6 relative
observed): every gradient within 1e-4 of its largest magnitude.  With bf16
x, B, C and dy on both sides, the f32 gradients (dt, a_log, D) within 1e-4
of their largest magnitude and the bf16 ones (x, B, C), each rounded once
from f32 sums taken in another order, within one bf16 step doubled (2^-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import layers as JL
from repro.core import lightweight as JLW
from repro.models import mamba as JMB
from repro.models import model as JModel
from repro_torch import configs as tconfigs
from repro_torch.core import lightweight as TLW
from repro_torch.kernels import ssd_scan as TSSD
from repro_torch.models import mamba as TMB

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

H, P, N, CHUNK = 8, 16, 16, 16           # the smoke mamba2-130m's SSD geometry
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
NAMES = ("x", "dt", "a_log", "b", "c", "d_skip")
F32_GRADS = ("dt", "a_log", "d_skip")    # f32 whatever x's dtype


def _inputs(b, s, dtype="float32", seed=0):
    """x, dt, a_log, B, C, D and the cotangents dy, d(final state); in bf16
    x, B, C and dy are bf16 values for both sides."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, H)) - 1)).astype(np.float32)
    a_log = (rng.standard_normal(H) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, N)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, N)) * 0.3).astype(np.float32)
    d = (1 + rng.standard_normal(H) * 0.1).astype(np.float32)
    dy = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dfin = rng.standard_normal((b, H, N, P)).astype(np.float32)
    if dtype == "bfloat16":
        x, bm, cm, dy = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                         for a in (x, bm, cm, dy))
    return (x, dt, a_log, bm, cm, d), dy, dfin


def _torch(args, dtype):
    tdt = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(tdt if k in (0, 3, 4) else torch.float32)
                 for k, a in enumerate(args))


def _jax_grads(args, dy, dfin, dtype, chunk):
    """``jax.vjp`` of the reference's ``ssd_chunked`` at the cotangents."""
    jdt = getattr(jnp, dtype)
    jargs = [jnp.asarray(a).astype(jdt) if k in (0, 3, 4) else jnp.asarray(a)
             for k, a in enumerate(args)]
    _, vjp = jax.vjp(lambda *a: JMB.ssd_chunked(*a, chunk), *jargs)
    return [np.asarray(g, np.float32) for g in vjp((jnp.asarray(dy).astype(jdt),
                                                     jnp.asarray(dfin)))]


def _close(got, ref, tol, what):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


# --------------------------------------------------------------------------
# (a) the plain version and the autograd function against jax.grad
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,dtype", [(2, 64, "float32"), (3, 12, "float32"),
                                       (2, 48, "bfloat16")],
                         ids=["four-chunks", "ragged-chunk", "bf16"])
def test_ssd_bwd_plain_and_fn_match_jax_grad(b, s, dtype):
    """Four chunks of 16, one chunk shorter than 16 (q = 12) and bf16
    inputs, with a nonzero cotangent on the final state: ``ssd_scan_bwd_plain``
    and the gradients autograd takes through ``SSDScanFn`` (which calls it,
    once) against ``jax.grad``; the dtypes are the inputs'."""
    args, dy, dfin = _inputs(b, s, dtype, seed=s)
    want = _jax_grads(args, dy, dfin, dtype, CHUNK)
    targs = _torch(args, dtype)
    tdy = torch.from_numpy(dy).to(targs[0].dtype)
    tdfin = torch.from_numpy(dfin)
    plain = TSSD.ssd_scan_bwd_plain(*targs, tdy, tdfin, CHUNK)
    leaves = [t.clone().requires_grad_() for t in targs]
    calls = TSSD.ssd_scan_bwd_plain.calls
    y, state = TSSD.ssd_scan(*leaves, CHUNK)
    assert y.grad_fn is not None and "SSDScanFn" in type(y.grad_fn).__name__
    fn = torch.autograd.grad((y.float() * tdy.float()).sum() + (state * tdfin).sum(), leaves)
    assert TSSD.ssd_scan_bwd_plain.calls == calls + 1
    for name, p, f, w, t in zip(NAMES, plain, fn, want, targs):
        assert p.dtype == f.dtype == t.dtype, name
        tol = TOL["float32"] if name in F32_GRADS else TOL[dtype]
        _close(p, w, tol, f"plain d{name}")
        _close(f, w, tol, f"SSDScanFn d{name}")


def test_ssd_fn_without_a_final_state_cotangent():
    """A loss that reads only y gives the final state no cotangent (None,
    not materialized): the gradients equal the plain version's with
    ``d_final=None`` bit for bit, and its gradients at an explicit zero
    cotangent (whose agreement with jax.grad the test above shows)."""
    args, dy, _ = _inputs(2, 32, seed=5)
    targs = _torch(args, "float32")
    tdy = torch.from_numpy(dy)
    leaves = [t.clone().requires_grad_() for t in targs]
    y, _ = TSSD.ssd_scan(*leaves, CHUNK)
    fn = torch.autograd.grad((y * tdy).sum(), leaves)
    plain = TSSD.ssd_scan_bwd_plain(*targs, tdy, None, CHUNK)
    zero = TSSD.ssd_scan_bwd_plain(*targs, tdy, torch.zeros(2, H, N, P), CHUNK)
    for name, f, p, z in zip(NAMES, fn, plain, zero):
        assert torch.equal(f, p), name
        _close(f, z.numpy(), 1e-6, name)


def test_padded_path_grads_match_the_sequential_oracle():
    """``models.mamba.ssd_chunked`` on a sequence that is not a whole number
    of chunks (40 = 2.5 chunks of 16) pads it with dt = 0 steps, which the
    reference cannot take: its gradients through ``F.pad`` and ``SSDScanFn``
    against autograd of the sequential ``ssd_scan_ref`` on the unpadded
    sequence, y's and the final state's cotangents both nonzero."""
    args, dy, dfin = _inputs(2, 40, seed=7)
    targs = _torch(args, "float32")
    tdy, tdfin = torch.from_numpy(dy), torch.from_numpy(dfin)
    grads = {}
    for name, fn in (("chunked", lambda *a: TMB.ssd_chunked(*a, CHUNK)),
                     ("sequential", TSSD.ssd_scan_ref)):
        leaves = [t.clone().requires_grad_() for t in targs]
        y, state = fn(*leaves)
        assert tuple(y.shape) == (2, 40, H, P)
        grads[name] = torch.autograd.grad((y * tdy).sum() + (state * tdfin).sum(), leaves)
    for name, g, r in zip(NAMES, grads["chunked"], grads["sequential"]):
        _close(g, r.numpy(), TOL["float32"], name)


# --------------------------------------------------------------------------
# (b) the backward's launch plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("q", [1, 16, 100, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_bwd_plan_fits_and_sizes_the_scratch(q, dtype):
    """At q in {1, 16, 100, 128}, N in {8, 16, 128}, P in {8, 16, 64}: every
    launch's shared memory fits a block (227 KB), launches 2 and 4 take none;
    the group divides H; launch 1 has a block per (batch, chunk, group),
    launch 3 two, launch 2 covers every state element, launch 4 a block a
    head and a thread per dB and dC element; the scratch is the f32 d(state)
    (B, NC, H, N, P), two d(dac) (B, NC, H, q), the last positions' extra
    (B, NC, H), <dy, x> (B, S, H) and the groups' dB and dC."""
    b, h, nc = 2, 24, 3
    s = nc * q
    for n in (8, 16, 128):
        for p in (8, 16, 64):
            plan = TSSD._ssd_bwd_plan(b, s, h, p, n, q, dtype)
            assert max(plan.smem) <= TSSD.SMEM_LIMIT and plan.smem[1] == plan.smem[3] == 0
            assert 1 <= plan.group <= TSSD.SSD_GMAX and h % plan.group == 0
            groups = h // plan.group
            assert plan.grids[0] == b * nc * groups and plan.grids[2] == 2 * plan.grids[0]
            per = TSSD.SSD_PASS * (4 if n * p % 4 == 0 else 1)
            assert plan.grids[1] * per >= b * h * n * p > (plan.grids[1] - b * h) * per
            assert (plan.grids[3] - h) * 256 >= 2 * b * s * n
            units = b * nc * h
            assert plan.workspace == 4 * (units * n * p + 2 * units * q + units + b * s * h
                                          + 2 * b * nc * groups * q * n)


def test_ssd_bwd_plan_at_the_path_shapes():
    """mamba2-130m's training shape (4 x 512) and chip_smoke's cases: one
    block an SM in launch 3, so the group fills the card in as few waves as
    its work allows (6 heads: 128 blocks at 4 x 512, one wave of 132 SMs);
    float32's tiles still fit at the largest group; 21.6 MB of scratch at
    4 x 512 against the forward's 12.6 MB."""
    want = {(4, 512): 6, (8, 512): 6, (8, 100): 3, (1, 4096): 6}
    for (b, s), group in want.items():
        q = min(128, s)
        for dtype in ("bfloat16", "float32"):
            plan = TSSD._ssd_bwd_plan(b, s, 24, 64, 128, q, dtype)
            assert plan.group == group, (b, s, dtype, plan)
    plan = TSSD._ssd_bwd_plan(4, 512, 24, 64, 128, 128)
    assert plan.grids[2] == 128 and plan.workspace == 21_562_880
    assert TSSD._ssd_plan(4, 512, 24, 64, 128, 128).workspace == 12_584_448
    assert TSSD._ssd_bwd_smem(128, 128, 64, 8, "float32")[2] <= TSSD.SMEM_LIMIT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(run these on the H100 with `python -m pytest -q "
                    "tests/test_torch_ssd_grad.py -k cuda`)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_ssd_bwd_plan_agrees_with_the_source(cuda):
    """``_ssd_bwd_plan``'s shared memory and scratch against the compiled
    source's ``ssd_scan_bwd_smem`` / ``ssd_scan_bwd_workspace``, at every
    head group and the corners the kernel takes, both dtypes."""
    lib = TSSD._bwd_lib()
    for q in (1, 16, 100, 128):
        for n in (8, 16, 128):
            for p in (8, 16, 64):
                for dtype, code in (("float32", 0), ("bfloat16", 1)):
                    for g in range(1, TSSD.SSD_GMAX + 1):
                        assert tuple(lib.ssd_scan_bwd_smem(k, q, n, p, g, code)
                                     for k in (1, 2, 3, 4)) == \
                            TSSD._ssd_bwd_smem(q, n, p, g, dtype), (q, n, p, g, dtype)
                    assert lib.ssd_scan_bwd_workspace(2, 3 * q, 24, p, n, q, 4) == \
                        TSSD._ssd_bwd_workspace(2, 3 * q, 24, p, n, q, 4)


@pytest.mark.cuda
def test_cuda_ssd_scan_bwd_matches_plain(cuda):
    """The backward kernel against its plain version: mamba2-130m's head
    geometry at 2 x 512, a 100-token chunk, the smoke geometry and a ragged
    one (q = 11, P = 13, N = 5), both dtypes, with and without a final-state
    cotangent; two calls give the same bits; every gradient within
    ``TOL`` of its largest magnitude (float32 ones in bf16 within 1e-4)."""
    for (b, s, h, p, n), chunk in (((2, 512, 24, 64, 128), 128), ((2, 100, 24, 64, 128), 128),
                                   ((2, 64, 8, 16, 16), 16), ((1, 33, 2, 13, 5), 11)):
        for dtype in ("float32", "bfloat16"):
            for with_final in (True, False):
                g = torch.Generator().manual_seed(1)
                tdt = getattr(torch, dtype)
                x = torch.randn(b, s, h, p, generator=g).to(cuda, tdt)
                dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=g) - 2).to(cuda)
                a_log = (0.5 * torch.randn(h, generator=g)).to(cuda)
                bm = (0.3 * torch.randn(b, s, n, generator=g)).to(cuda, tdt)
                cm = (0.3 * torch.randn(b, s, n, generator=g)).to(cuda, tdt)
                d = (1 + 0.1 * torch.randn(h, generator=g)).to(cuda)
                dy = torch.randn(b, s, h, p, generator=g).to(cuda, tdt)
                dfin = torch.randn(b, h, n, p, generator=g).to(cuda) if with_final else None
                args = (x, dt, a_log, bm, cm, d)
                fws = TSSD._forward(*args, chunk)[2]
                launches = TSSD.ssd_scan_bwd.launches
                got = TSSD.ssd_scan_bwd(*args, dy, dfin, fws, chunk)
                again = TSSD.ssd_scan_bwd(*args, dy, dfin, fws, chunk)
                torch.cuda.synchronize()
                assert TSSD.ssd_scan_bwd.launches == launches + 2
                assert all(torch.equal(u, v) for u, v in zip(got, again))
                ref = TSSD.ssd_scan_bwd_plain(*args, dy, dfin, chunk)
                for name, u, r in zip(NAMES, got, ref):
                    tol = TOL["float32"] if name in F32_GRADS else TOL[dtype]
                    err = (u.float() - r.float()).abs().max()
                    assert err <= tol * r.float().abs().max(), (name, dtype, b, s, float(err))


# --------------------------------------------------------------------------
# (c) the ssm family's LFA split at full width
# --------------------------------------------------------------------------


def test_full_width_mamba2_lfa_counts():
    """The LFA split of full-width mamba2-130m, counted abstractly on both
    sides (``jax.eval_shape``; the port on the meta device): the auxiliary
    cores, norms and SSD vectors train, the central cores do not."""
    jparams, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config("mamba2-130m")).init, jax.random.PRNGKey(0)))
    jc = JLW.count_trainable(jparams, JLW.trainable_mask(jparams, mode="lfa"))
    with torch.device("meta"):
        params = TMB.init(torch.Generator(), tconfigs.get_config("mamba2-130m"))
    tc = TLW.count_trainable(params, TLW.trainable_mask(params, mode="lfa"))
    assert tc == jc
    assert 0 < tc[0] < tc[1]

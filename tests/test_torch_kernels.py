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
steps (3e-2 on O(1) values, as tests/test_kernels.py allows)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mpo as JM
from repro.kernels import decode_attention as JDA
from repro.kernels.mpo_linear import mpo_linear as j_mpo_linear
from repro.kernels.ref import mpo_linear_ref
from repro_torch import configs
from repro_torch.kernels import decode_attention as TDA
from repro_torch.kernels import mpo_linear as TMK
from repro_torch.models import model as TModel

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
            for tile in TMK.TILES:
                split, njp = TMK._launch_plan(tuple(sh), tile)
                assert TMK._smem_bytes(sh, split, njp, tile) <= TMK.SMEM_LIMIT
            # no forward-only kernel for training, no float16 kernel
            assert not TMK.kernel_eligible(sh, train=True)
            assert not TMK.kernel_eligible(sh, dtype="float16")


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


def test_cuda_mpo_linear_matches_plain(cuda):
    for name, s in _bert_matrix_shapes().items():
        if name == "embed":
            continue
        rng = np.random.default_rng(0)
        cores = [torch.from_numpy((rng.standard_normal(c) * 0.35).astype(np.float32))
                 for c in s]
        for m in (8, 37, 1024):
            x = torch.from_numpy(rng.standard_normal((m, cores[0].shape[1] * math.prod(
                c.shape[1] for c in cores[1:]))).astype(np.float32))
            for dtype in (torch.float32, torch.bfloat16):
                cs = [c.to(cuda, dtype) for c in cores]
                xx = x.to(cuda, dtype)
                launches = TMK.mpo_linear.launches
                y = TMK.mpo_linear(cs, xx)
                torch.cuda.synchronize()
                assert TMK.mpo_linear.launches == launches + 1
                ref = TMK.mpo_linear_plain(cs, xx).float()
                tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
                assert (y.float() - ref).abs().max() <= tol * ref.abs().max()


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

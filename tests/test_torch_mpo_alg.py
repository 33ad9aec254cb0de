"""Algorithm 1 and the TT-rounding of Algorithm 2 in the port
(``repro_torch.core.mpo``) held against the JAX package on the same numpy
inputs, unstacked and stacked (a leading layer dim, one batched call).

SVD signs and the gauge between cores differ between the two frameworks'
LAPACK calls, so cores are never compared directly: reconstructions and
spectra are.  Both work in float32, summed in another order: a
reconstruction agrees within 1e-5 of ||W||_F, a spectrum within 1e-5 of its
largest value (observed ~1e-6), the Eq. 3/4/6 helpers within 1e-6
relative on the same spectra.  One exception: Algorithm 1 truncating a
full-rank Gaussian matrix cuts between singular values ~1% apart, so a
float32 rounding turns the kept subspace by ~eps/gap; each framework's
reconstruction lies up to 2e-5 of ||W||_F from the float64 decomposition's
(measured), and the spectra after the first truncated bond, taken of the
truncated remainder, move with it (1.1e-5 of their largest value observed),
so the two are held within 1e-4 there (``TRUNC_TOL``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convert as JC
from repro.core import mpo as JM
from repro_torch.core import convert as TC
from repro_torch.core import mpo as TM

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = 1e-5
TRUNC_TOL = 1e-4
HELPER_TOL = 1e-6
LAYERS = 3

SPECS = [((24, 36), 3, None), ((64, 96), 3, 8), ((64, 64), 5, 8), ((128, 48), 4, 6),
         ((768, 768), 5, 16)]


def _cores(shapes, seed=0, lead=()):
    """Cores whose matrix has O(1) entries (optionally stacked)."""
    rng = np.random.default_rng(seed)
    bonds = math.prod(s[3] for s in shapes[:-1])
    sigma = (1.0 / bonds) ** (1.0 / (2 * len(shapes)))
    return [(rng.standard_normal(lead + tuple(s)) * sigma).astype(np.float32) for s in shapes]


def _layer(cores, i):
    return [c[i] for c in cores]


def _norm(cores):
    """||W||_F of the matrix ``cores`` contract to."""
    return float(np.linalg.norm(np.asarray(JM.reconstruct([jnp.asarray(c) for c in cores]))))


def _rec_close(t_cores, j_cores, w_norm, tol=TOL):
    """Reconstructions within ``tol`` of ||W||_F (``w_norm``, the matrix
    they approximate)."""
    rt = TM.reconstruct([torch.as_tensor(c) for c in t_cores]).numpy()
    rj = np.asarray(JM.reconstruct([jnp.asarray(c) for c in j_cores]))
    assert np.linalg.norm(rt - rj) <= tol * w_norm


def _spectra_close(t, j, tol=TOL):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * b.max())


@pytest.mark.parametrize("dims,n,bond", SPECS)
@pytest.mark.parametrize("kind", ["gaussian", "exact"])
def test_decompose_matches_reference(dims, n, bond, kind):
    """Algorithm 1 on a full-rank Gaussian matrix (truncated) and on one of
    rank <= the bonds at every unfolding (exact), unstacked and as a stack
    of three: the same core shapes, reconstructions and pre-truncation
    spectra as the reference's."""
    spec_j = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    spec_t = TM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(1)
    if kind == "gaussian":
        ws = rng.standard_normal((LAYERS,) + dims).astype(np.float32)
    else:
        cs = _cores(spec_j.core_shapes(), seed=2, lead=(LAYERS,))
        ws = np.stack([np.asarray(JM.reconstruct([jnp.asarray(c) for c in _layer(cs, i)]))
                       for i in range(LAYERS)])
    t_cores, t_spec = TM.decompose(torch.from_numpy(ws), spec_t)
    tol = TRUNC_TOL if kind == "gaussian" else TOL
    for i in range(LAYERS):
        j_cores, j_spec = JM.decompose(jnp.asarray(ws[i]), spec_j)
        u_cores, u_spec = TM.decompose(torch.from_numpy(ws[i]), spec_t)
        assert [tuple(c.shape) for c in u_cores] == [tuple(c.shape) for c in j_cores]
        assert [tuple(c.shape[1:]) for c in t_cores] == [tuple(c.shape) for c in j_cores]
        w_norm = float(np.linalg.norm(ws[i]))
        _rec_close(u_cores, j_cores, w_norm, tol)
        _rec_close(_layer(t_cores, i), j_cores, w_norm, tol)
        _spectra_close(u_spec, j_spec, tol)
        _spectra_close([s[i] for s in t_spec], j_spec, tol)
        if kind == "exact":
            rec = TM.reconstruct(u_cores).numpy()
            assert np.linalg.norm(rec - ws[i]) <= TOL * np.linalg.norm(ws[i])


def test_decompose_through_the_qr_route_matches_reference(monkeypatch):
    """Algorithm 1 with every SVD through ``_svd_qr`` (the card's route for
    unfoldings of ``SVD_QR_ENTRIES`` entries or more, here forced on the
    CPU), unstacked and stacked, on a full-rank Gaussian and an exact
    matrix: the reference's reconstructions and spectra, within the
    tolerances of the LAPACK route above."""
    monkeypatch.setattr(TM, "_svd", TM._svd_qr)
    dims, n, bond = (128, 48), 4, 6
    spec_j = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    spec_t = TM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    rng = np.random.default_rng(4)
    cs = _cores(spec_j.core_shapes(), seed=5)
    exact = np.asarray(JM.reconstruct([jnp.asarray(c) for c in cs]))
    for w, tol in ((rng.standard_normal(dims).astype(np.float32), TRUNC_TOL), (exact, TOL)):
        j_cores, j_spec = JM.decompose(jnp.asarray(w), spec_j)
        w_norm = float(np.linalg.norm(w))
        for lead in ((), (2,)):
            t_cores, t_spec = TM.decompose(torch.from_numpy(np.broadcast_to(w, lead + dims)
                                                            .copy()), spec_t)
            if lead:
                t_cores, t_spec = _layer(t_cores, 1), [s[1] for s in t_spec]
            _rec_close(t_cores, j_cores, w_norm, tol)
            _spectra_close(t_spec, j_spec, tol)


def test_decompose_rejects_a_wrong_shape():
    with pytest.raises(ValueError, match="spec"):
        TM.decompose(torch.zeros(3, 24, 35), TM.MPOSpec.make(24, 36, n=3))


def test_decompose_to_shapes_pads_like_the_reference():
    """A template whose bonds exceed the matrix's canonical ones: zero
    padding, the reference's shapes and the same (exact) reconstruction;
    a core larger than the template raises."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    shapes = [(1, 2, 2, 8), (8, 2, 2, 1)]
    tc = TC._decompose_to_shapes(torch.from_numpy(w), shapes)
    jc = JC._decompose_to_shapes(jnp.asarray(w), shapes)
    assert [tuple(c.shape) for c in tc] == [tuple(c.shape) for c in jc] == shapes
    assert torch.count_nonzero(tc[0][..., 4:]) == 0 and torch.count_nonzero(tc[1][4:]) == 0
    _rec_close(tc, jc, np.linalg.norm(w))
    stacked = TC._decompose_to_shapes(torch.from_numpy(np.stack([w, 2 * w])), shapes)
    assert [tuple(c.shape) for c in stacked] == [(2,) + s for s in shapes]
    _rec_close(_layer(stacked, 0), jc, np.linalg.norm(w))
    w8 = rng.standard_normal((8, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="template"):   # bond 2 of a max-4 spec comes out 4
        TC._decompose_to_shapes(torch.from_numpy(w8), [(1, 2, 2, 4), (4, 2, 2, 2), (2, 2, 2, 1)])


def _spectrum(lead=(), r=24, seed=4):
    rng = np.random.default_rng(seed)
    return -np.sort(-np.abs(rng.standard_normal(lead + (r,))), axis=-1).astype(np.float32)


@pytest.mark.parametrize("keep", [0, 1, 7, 24])
def test_error_and_entropy_helpers_match_reference(keep):
    """Eq. 3 (l2 tail and the literal sum), Eq. 4's bound and Eq. 6's
    entropy, unstacked and over a leading layer dim, within 1e-6
    relative of the reference's."""
    s = _spectrum()
    st = _spectrum((LAYERS,), seed=5)
    spectra = [_spectrum(seed=6 + k) for k in range(3)]
    keeps = [keep, max(keep - 1, 0), min(keep + 2, 24)]
    pairs = [
        (TM.local_truncation_error(torch.from_numpy(s), keep),
         JM.local_truncation_error(jnp.asarray(s), keep)),
        (TM.paper_epsilon(torch.from_numpy(s), keep), JM.paper_epsilon(jnp.asarray(s), keep)),
        (TM.entanglement_entropy(torch.from_numpy(s)), JM.entanglement_entropy(jnp.asarray(s))),
        (TM.total_error_bound([torch.from_numpy(x) for x in spectra], keeps),
         JM.total_error_bound([jnp.asarray(x) for x in spectra], keeps)),
        (TM.local_truncation_error(torch.from_numpy(st), keep),
         [JM.local_truncation_error(jnp.asarray(x), keep) for x in st]),
        (TM.paper_epsilon(torch.from_numpy(st), keep),
         [JM.paper_epsilon(jnp.asarray(x), keep) for x in st]),
        (TM.entanglement_entropy(torch.from_numpy(st)),
         [JM.entanglement_entropy(jnp.asarray(x)) for x in st]),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), rtol=HELPER_TOL,
                                   atol=HELPER_TOL)
    # a zero spectrum entry contributes nothing to the entropy (0 ln 0 = 0)
    z = torch.tensor([2.0, 1.0, 0.0])
    assert TM.entanglement_entropy(z).item() == pytest.approx(
        float(JM.entanglement_entropy(jnp.asarray(z.numpy()))), rel=HELPER_TOL)


@pytest.mark.parametrize("dims,n,bond", SPECS)
@pytest.mark.parametrize("stacked", [False, True])
def test_right_orthogonalize_matches_reference(dims, n, bond, stacked):
    """Every core but the first is right-orthogonal (its rows orthonormal),
    and the MPO is unchanged (the reference's reconstruction)."""
    shapes = JM.MPOSpec.make(*dims, n=n, bond_dim=bond).core_shapes()
    lead = (LAYERS,) if stacked else ()
    cores = _cores(shapes, lead=lead)
    out = TM.right_orthogonalize([torch.from_numpy(c) for c in cores])
    for i in range(LAYERS if stacked else 1):
        oc = _layer(out, i) if stacked else out
        ic = _layer(cores, i) if stacked else cores
        w_norm = _norm(ic)
        _rec_close(oc, JM.right_orthogonalize([jnp.asarray(c) for c in ic]), w_norm)
        _rec_close(oc, ic, w_norm)
        for c in oc[1:]:
            m = c.reshape(c.shape[0], -1)
            eye = torch.eye(m.shape[0])
            assert (m @ m.T - eye).abs().max() <= TOL


@pytest.mark.parametrize("dims,n,bond", SPECS)
@pytest.mark.parametrize("stacked", [False, True])
def test_bond_spectra_and_tt_round_match_reference(dims, n, bond, stacked):
    """``bond_spectra`` and ``tt_round`` (every bond truncated by 1, and by
    half) against the reference, layer by layer for a stack: spectra and
    reconstructions; TT-rounding to the current bonds keeps the matrix."""
    shapes = JM.MPOSpec.make(*dims, n=n, bond_dim=bond).core_shapes()
    lead = (LAYERS,) if stacked else ()
    cores = _cores(shapes, seed=7, lead=lead)
    tcores = [torch.from_numpy(c) for c in cores]
    bonds = [s[3] for s in shapes[:-1]]
    t_spec = TM.bond_spectra(tcores)
    for new in ([max(1, b - 1) for b in bonds], [max(1, b // 2) for b in bonds], bonds):
        t_round, t_rspec = TM.tt_round(tcores, new)
        assert [tuple(c.shape[-4:]) for c in t_round] == [
            (a, s[1], s[2], b) for s, a, b in zip(shapes, [1] + new, new + [1])]
        for i in range(LAYERS if stacked else 1):
            ic = [jnp.asarray(c) for c in (_layer(cores, i) if stacked else cores)]
            j_round, j_rspec = JM.tt_round(ic, new)
            pick = (lambda t: [x[i] for x in t]) if stacked else (lambda t: t)
            w_norm = _norm(ic)
            _rec_close(pick(t_round), j_round, w_norm)
            _spectra_close(pick(t_rspec), j_rspec)
            _spectra_close(pick(t_spec), JM.bond_spectra(ic))
            if new == bonds:
                _rec_close(pick(t_round), ic, w_norm)


def test_apply_mpo_t_matches_reference():
    shapes = JM.MPOSpec.make(64, 96, n=3, bond_dim=8).core_shapes()
    cores = _cores(shapes)
    x = np.random.default_rng(8).standard_normal((5, 96)).astype(np.float32)
    t = TM.apply_mpo_t([torch.from_numpy(c) for c in cores], torch.from_numpy(x))
    j = JM.apply_mpo_t([jnp.asarray(c) for c in cores], jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)

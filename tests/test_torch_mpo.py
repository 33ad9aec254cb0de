"""The port's MPO math and layers (``repro_torch.core.mpo`` / ``layers``)
held against the JAX package on the same numpy inputs.

Tolerances: float32 contractions summed in another order by the two
frameworks agree to ~1e-6 relative; 1e-5 absolute on O(1) values leaves
room for the longest chains here."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as JL
from repro.core import mpo as JM
from repro_torch.core import layers as TL
from repro_torch.core import mpo as TM

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = 1e-5

SPECS = [((24, 36), 3, None), ((64, 96), 3, 8), ((64, 64), 5, 8),
         ((768, 768), 5, 16), ((128, 48), 4, 6), ((30720, 64), 5, 8)]


def _cores(spec_shapes, seed=0):
    """Cores scaled so the matrix they contract to has O(1) entries."""
    rng = np.random.default_rng(seed)
    bonds = math.prod(s[3] for s in spec_shapes[:-1])
    sigma = (1.0 / bonds) ** (1.0 / (2 * len(spec_shapes)))
    return [(rng.standard_normal(s) * sigma).astype(np.float32) for s in spec_shapes]


def _close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(j).max())))


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree.items()}


@pytest.mark.parametrize("n,parts,multiple,idx", [
    (768, 5, 1, 0), (3072, 5, 1, 0), (30720, 5, 1, 0), (5120, 5, 16, 0),
    (17408, 5, 16, 0), (151936, 5, 16, 2), (64, 3, 4, 1), (97, 4, 1, 0)])
def test_auto_factorize_matches(n, parts, multiple, idx):
    assert TM.auto_factorize(n, parts, multiple, idx) == \
        JM.auto_factorize(n, parts, multiple, idx)


@pytest.mark.parametrize("dims,n,bond", SPECS)
def test_spec_matches(dims, n, bond):
    js = JM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    ts = TM.MPOSpec.make(*dims, n=n, bond_dim=bond)
    assert ts.core_shapes() == js.core_shapes()
    assert ts.bonds() == js.bonds() and ts.full_bonds() == js.full_bonds()
    assert ts.num_params() == js.num_params()
    assert ts.compression_ratio() == js.compression_ratio()
    assert ts.central_index == js.central_index


@pytest.mark.parametrize("dims,n,bond", SPECS[:5])
def test_contractions_match(dims, n, bond):
    shapes = JM.MPOSpec.make(*dims, n=n, bond_dim=bond).core_shapes()
    cores = _cores(shapes)
    jc = [jnp.asarray(c) for c in cores]
    tc = [torch.from_numpy(c) for c in cores]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, dims[0])).astype(np.float32)
    xt = rng.standard_normal((7, dims[1])).astype(np.float32)
    pairs = [
        (JM.reconstruct(jc), TM.reconstruct(tc)),
        (JM.apply_mpo(jc, jnp.asarray(x)), TM.apply_mpo(tc, torch.from_numpy(x))),
        (JM.apply_mpo_t(jc, jnp.asarray(xt)),
         TM.apply_mpo(TM.transpose_cores(tc), torch.from_numpy(xt))),
        (JM.matmul_reconstruct(jnp.asarray(x), tuple(jc)),
         TM.matmul_reconstruct(torch.from_numpy(x), tc)),
    ]
    for j, t in pairs:
        assert tuple(t.shape) == j.shape
        _close(t, j)
    assert TM.count_params(tc) == JM.count_params(jc)


@pytest.mark.parametrize("dims,n,bond", [((512, 64), 5, 8), ((30720, 48), 5, 8),
                                         ((97, 16), 3, None)])
def test_embed_lookup_matches(dims, n, bond):
    shapes = JM.MPOSpec.make(*dims, n=n, bond_dim=bond).core_shapes()
    cores = _cores(shapes, seed=2)
    ids = np.random.default_rng(3).integers(0, dims[0], (3, 11)).astype(np.int32)
    j = JM.embed_lookup([jnp.asarray(c) for c in cores], jnp.asarray(ids))
    t = TM.embed_lookup([torch.from_numpy(c) for c in cores], torch.from_numpy(ids))
    _close(t, j)
    # and it is the row gather of the reconstructed table
    w = TM.reconstruct([torch.from_numpy(c) for c in cores])
    _close(t, w[torch.from_numpy(ids).long()].numpy())


def test_init_cores_shapes_and_scale():
    spec = TM.MPOSpec.make(768, 3072, n=5, bond_dim=64)
    cores = TM.init_cores(torch.Generator().manual_seed(0), spec)
    jcores = jax.eval_shape(lambda k: JM.init_cores(
        k, JM.MPOSpec.make(768, 3072, n=5, bond_dim=64)), jax.random.PRNGKey(0))
    assert [tuple(c.shape) for c in cores] == [c.shape for c in jcores]
    sigma = (1.0 / 768 / math.prod(spec.bonds())) ** (1.0 / 10)
    central = cores[spec.central_index]
    assert abs(central.std().item() / sigma - 1.0) < 0.05
    # the reconstructed matrix has fan-in variance
    w = TM.reconstruct(cores)
    assert abs(w.var().item() * 768 - 1.0) < 0.25


@pytest.mark.parametrize("kind,in_sh,out_sh", [("attn", False, True),
                                               ("ffn", True, False),
                                               ("embed", False, False)])
@pytest.mark.parametrize("mult", [1, 16])
def test_make_spec_and_init_linear_match(kind, in_sh, out_sh, mult):
    jcfg = JL.MPOConfig(n=5, bond_attn=32, bond_ffn=24, bond_embed=16,
                        shard_multiple=mult)
    tcfg = TL.MPOConfig(n=5, bond_attn=32, bond_ffn=24, bond_embed=16,
                        shard_multiple=mult)
    js = JL.make_spec(jcfg, 5120, 1024, kind, in_sh, out_sh)
    ts = TL.make_spec(tcfg, 5120, 1024, kind, in_sh, out_sh)
    assert ts.core_shapes() == js.core_shapes()
    jp, _ = JL.split_annotations(jax.eval_shape(lambda k: JL.init_linear(
        k, 5120, 1024, cfg=jcfg, kind=kind, sharded_in=in_sh,
        sharded_out=out_sh), jax.random.PRNGKey(0)))
    tp = TL.init_linear(torch.Generator().manual_seed(0), 5120, 1024, cfg=tcfg,
                        kind=kind, sharded_in=in_sh, sharded_out=out_sh)
    assert _shapes(tp["cores"]) == _shapes(jp["cores"])


def test_dense_linear_and_core_naming():
    tp = TL.init_linear(torch.Generator().manual_seed(0), 64, 2, cfg=TL.DENSE)
    jp, _ = JL.split_annotations(jax.eval_shape(
        lambda k: JL.init_linear(k, 64, 2, cfg=JL.DENSE), jax.random.PRNGKey(0)))
    assert tuple(tp["w"].shape) == jp["w"].shape
    for n in (1, 3, 4, 5, 7):
        assert TL.core_names(n) == JL.core_names(n)
        cs = [torch.zeros(k) for k in range(n)]
        assert TL.cores_to_list(TL.cores_from_list(cs)) == cs
    emb = TL.init_embedding(torch.Generator().manual_seed(0), 512, 64,
                            cfg=TL.MPOConfig(bond_embed=8))
    jemb, _ = JL.split_annotations(jax.eval_shape(lambda k: JL.init_embedding(
        k, 512, 64, cfg=JL.MPOConfig(bond_embed=8)), jax.random.PRNGKey(0)))
    assert _shapes(emb["cores"]) == _shapes(jemb["cores"])

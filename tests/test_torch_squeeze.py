"""Algorithm 2 in the port (``repro_torch.core.squeeze``) held against the
JAX package on the same numpy trees: layer discovery, the least-error
candidate and one squeeze move (unstacked and scan-stacked cores), the stop
rule of ``run_dimension_squeezing`` with scripted metrics, and the
compression ratio (the port counts each layer of a stack as its own matrix,
ROADMAP.md Queue 3 item C; the reference misreads stacked cores).

The least-error bond is an argmin over float32 errors that the two
frameworks compute with other LAPACK calls (~1e-6 relative apart), so every
comparison of a choice first asserts that the winner leads the runner-up by
more than ``GAP`` (1e-3 relative) and fails loudly where it does not: it
never passes on a near-tie.  Predicted errors agree within 1e-5 relative,
reconstructions within 1e-5 of ||W||_F."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import squeeze as JSQ
from repro_torch.core import layers as TL
from repro_torch.core import mpo as TM
from repro_torch.core import squeeze as TSQ

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = 1e-5
GAP = 1e-3
LAYERS = 3


def _tree(stacked: bool, seed: int = 0) -> dict:
    """Two factorized matrices (48 -> 96, 96 -> 48; n = 3, bonds up to 12),
    a dense one and a norm, as a numpy tree; ``stacked`` draws each matrix
    LAYERS times and stacks it along a leading layer dim."""
    cfg = TL.MPOConfig(n=3, bond_ffn=12, bond_attn=12, bond_embed=12)
    gen = torch.Generator().manual_seed(seed)

    def lin(i, o):
        draws = [TL.init_linear(gen, i, o, cfg=cfg) for _ in range(LAYERS if stacked else 1)]
        cores = {k: np.stack([d["cores"][k].numpy() for d in draws]) if stacked
                 else draws[0]["cores"][k].numpy() for k in draws[0]["cores"]}
        return {"cores": cores}

    return {"l1": lin(48, 96), "l2": lin(96, 48),
            "head": {"w": np.ones((48, 4), np.float32)},
            "norm": {"scale": np.ones(48, np.float32)}}


def _port(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _ref(tree):
    return jax.tree.map(jnp.asarray, tree)


def _clear_winner(params, step=1):
    """The port's candidates sorted by error; fails unless the best leads the
    second by more than GAP relative."""
    cands = sorted(TSQ.candidates(TSQ.find_mpo_layers(params), step=step),
                   key=lambda c: c[-1])
    assert len(cands) >= 2
    gap = (cands[1][-1] - cands[0][-1]) / cands[0][-1]
    assert gap > GAP, (f"near-tie: {cands[0][:2]} {cands[0][-1]} vs {cands[1][:2]} "
                       f"{cands[1][-1]} (gap {gap}): the frameworks may pick either")
    return cands


def _recs(cores_dict):
    return TM.reconstruct_stacked([torch.tensor(np.asarray(c))
                                   for c in TL.cores_to_list(cores_dict)]).numpy()


def test_find_mpo_layers_matches_reference():
    tree = _tree(stacked=True)
    t, j = TSQ.find_mpo_layers(_port(tree)), JSQ.find_mpo_layers(_ref(tree))
    assert list(t) == list(j) == [("l1", "cores"), ("l2", "cores")]
    assert TSQ.find_mpo_layers({"a": [{"central": 1}, {"x": 2}]}) == {("a", 0): {"central": 1}}


def test_set_at_path_copies_the_path_and_shares_the_rest():
    tree = _port(_tree(stacked=False))
    new = TSQ.set_at_path(tree, ("l1", "cores"), {"central": torch.zeros(1)})
    assert new is not tree and new["l1"] is not tree["l1"]
    assert new["l2"] is tree["l2"] and new["norm"]["scale"] is tree["norm"]["scale"]
    assert "c0" in tree["l1"]["cores"] and list(new["l1"]["cores"]) == ["central"]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("step", [1, 3])
def test_least_error_candidate_and_squeeze_once_match_reference(stacked, step):
    """Three squeeze moves in a row, each from the tree the last one left:
    the same (layer, bond, new bonds), the predicted error, and the
    squeezed matrix's reconstruction, against the reference's."""
    tree = _tree(stacked)
    tp, jp = _port(tree), _ref(tree)
    for _ in range(3):
        cands = _clear_winner(tp, step)
        tc = TSQ.least_error_candidate(TSQ.find_mpo_layers(tp), step=step)
        jc = JSQ.least_error_candidate(JSQ.find_mpo_layers(jp), step=step)
        assert tc[:3] == tuple(jc[:3]) == cands[0][:3]
        assert tc[3] == pytest.approx(float(jc[3]), rel=TOL)
        before = tp
        tp, tinfo = TSQ.squeeze_once(tp, step=step)
        jp, jinfo = JSQ.squeeze_once(jp, step=step)
        for k in ("layer", "bond", "new_dim"):
            assert tinfo[k] == jinfo[k], k
        assert tinfo["predicted_error"] == pytest.approx(jinfo["predicted_error"], rel=TOL)
        assert set(tinfo["seconds"]) == {"spectra", "tt_round"}
        path = tinfo["layer"]
        t_layer = TSQ.find_mpo_layers(tp)[path]
        j_layer = JSQ.find_mpo_layers(jp)[path]
        assert {k: tuple(v.shape) for k, v in t_layer.items()} == \
            {k: tuple(v.shape) for k, v in j_layer.items()}
        rt, rj = _recs(t_layer), _recs(j_layer)
        assert np.linalg.norm(rt - rj) <= TOL * np.linalg.norm(rj)
        # the other matrix and the non-MPO leaves are shared, not copied
        other = [p for p in TSQ.find_mpo_layers(tp) if p != path][0]
        assert TSQ.find_mpo_layers(tp)[other] is TSQ.find_mpo_layers(before)[other]
        assert tp["norm"]["scale"] is before["norm"]["scale"]


def test_squeeze_once_stops_at_min_bond():
    tree = _port(_tree(stacked=False))
    bonds = max(c.shape[-1] for c in TL.cores_to_list(tree["l1"]["cores"]))
    params, info = TSQ.squeeze_once(tree, min_bond=bonds + 1)
    assert info is None and params is tree
    assert TSQ.least_error_candidate(TSQ.find_mpo_layers(tree), min_bond=bonds + 1) is None


@pytest.mark.parametrize("stacked", [False, True])
def test_stop_rule_keeps_the_last_acceptable_tree(stacked):
    """Scripted metrics (baseline 1.0, then 0.99, 0.97, 0.5) with delta 0.1:
    the third iteration exceeds the gap, so the tree after the second is
    returned, untouched, with a history of three events; every evaluation
    saw the weight cache's snapshot; the same events as the reference's
    run on the same script."""
    script = [1.0, 0.99, 0.97, 0.5, 0.4]
    tree = _tree(stacked)
    seen, accepted = [], []

    def run(mod, params, wrap):
        it = iter(script)
        return mod.run_dimension_squeezing(
            params, lambda p: p, lambda p: (seen.append(p) if wrap else None) or next(it),
            delta=0.1, max_iters=5, weight_cache=(lambda p: {"snapshot": p}) if wrap else None,
            on_iteration=(lambda i, p, h, b: accepted.append(p)) if wrap else None)

    best, hist = run(TSQ, _port(tree), True)
    jbest, jhist = run(JSQ, _ref(tree), False)
    assert len(hist) == len(jhist) == 3
    assert [(e.layer, e.bond, e.new_dim, e.metric) for e in hist] == \
        [(e.layer, e.bond, e.new_dim, e.metric) for e in jhist]
    for e, je in zip(hist, jhist):
        assert e.predicted_error == pytest.approx(je.predicted_error, rel=TOL)
        assert set(e.seconds) == {"spectra", "tt_round", "retune", "eval"}
    assert len(accepted) == 2 and best is accepted[-1]
    assert all(set(s) == {"snapshot"} for s in seen) and len(seen) == 4
    # the rejected third tree was built beside the accepted one: the
    # accepted tree still has the shapes of two moves, as the reference's
    shapes = lambda p: {jax.tree_util.keystr(k): tuple(v.shape)
                        for k, v in jax.tree_util.tree_leaves_with_path(p)}
    assert shapes(best) == shapes(jbest)


def test_compression_ratio_counts_every_layer_of_a_stack():
    """Queue 3 item C: on a stacked tree the port's rho equals an
    independent count (core parameters over L * I * J for each matrix),
    which the reference's number is not (it reads a stacked core's d0 and i
    as its i and j legs); on an unstacked tree the two agree."""
    stacked = _tree(stacked=True)
    num = sum(v.size for m in ("l1", "l2") for v in stacked[m]["cores"].values())
    independent = num / (LAYERS * 48 * 96 + LAYERS * 96 * 48)
    rho = TSQ.model_compression_ratio(_port(stacked))
    assert rho == pytest.approx(independent, rel=1e-12)
    assert JSQ.model_compression_ratio(_ref(stacked)) != pytest.approx(independent, rel=1e-3)
    flat = _tree(stacked=False)
    assert TSQ.model_compression_ratio(_port(flat)) == pytest.approx(
        JSQ.model_compression_ratio(_ref(flat)), rel=1e-12)
    spec = TM.MPOSpec.make(48, 96, n=3, bond_dim=12)
    assert TSQ.model_compression_ratio({"a": {"cores": TL.cores_from_list(
        [torch.zeros(s) for s in spec.core_shapes()])}}) == pytest.approx(
        spec.compression_ratio())

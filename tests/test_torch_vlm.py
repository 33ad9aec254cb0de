"""The port's VLM family (the patch projector and the patches ahead of the
text in ``models.transformer``, the vlm batches of ``data.pipeline``)
against the JAX package: smoke llava-next-34b (2 layers, float32, 8 patches
of 24 features), the same weights in both (``core.carry.load_jax_params``).

Tolerances: logits and the loss within 1e-4 (two frameworks' float32 sums
in another order, as ``test_torch_model.py``); greedy tokens and batches
identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.core import layers as JL
from repro.data import pipeline as JP
from repro.models import model as JModel
from repro.train import steps as JSteps
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.carry import load_jax_params
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TModel
from repro_torch.train import steps as TSteps

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCH = "llava-next-34b"
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    src = TModel.build(tconfigs.smoke_config(ARCH), seed=7, device="cpu")
    tree = jax.tree.map(np.array, src.tree())
    abstract, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.smoke_config(ARCH)).init, jax.random.PRNGKey(0)))
    assert jax.tree.structure(abstract) == jax.tree.structure(tree)
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(jax.tree.leaves(abstract), jax.tree.leaves(tree)))
    js = JSession(jconfigs.smoke_config(ARCH), jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(ARCH, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _batch(cfg, b=3, s=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "patches": rng.normal(size=(b, cfg.frontend_len, cfg.frontend_dim))
            .astype(np.float32)}


def test_make_batch_fn_matches_reference():
    """Tokens, patches and labels (IGNORE over the patches) bit for bit, at
    two steps and two shards of a batch of 4; ``seq_len`` counts the
    patches."""
    tcfg, jcfg = tconfigs.smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    tfn = TP.make_batch_fn(tcfg, ShapeConfig("t", "train", 24, 4), seed=5)
    jfn = JP.make_batch_fn(jcfg, JShape("t", "train", 24, 4), seed=5)
    for step in (0, 3):
        for shard in (0, 1):
            tb, jb = tfn(step, shard, 2), jfn(step, shard, 2)
            assert set(tb) == set(jb) == {"tokens", "labels", "patches"}
            for k in tb:
                np.testing.assert_array_equal(tb[k], jb[k], k)
            assert tb["labels"].shape == (2, 24) and tb["tokens"].shape == (2, 16)
            assert (tb["labels"][:, :tcfg.frontend_len] == TP.IGNORE).all()


def test_forward_and_loss_match_reference(pair):
    """Logits over patches + text, and the LM loss of a vlm batch (its
    labels IGNORE over the patches)."""
    js, ts = pair
    flat = jax.tree_util.tree_flatten_with_path(js.params)[0]
    assert {k: tuple(v.shape) for k, v in ts.model.state_dict().items()} == \
        {".".join(p.key for p in path): leaf.shape for path, leaf in flat}
    batch = _batch(js.cfg)
    jl, _ = js.model.forward(js.params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        tl = ts.model({k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == (3, js.cfg.frontend_len + 10, js.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    b = TP.make_batch_fn(ts.cfg, ShapeConfig("t", "train", 24, 2), seed=1)(0)
    jloss, jm = JSteps.lm_loss(js.model, js.params, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        tloss, tm = TSteps.lm_loss(ts.model, ts.params,
                                   {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    # the last patch position predicts the first text token
    assert int(tm["tokens"]) == int(jm["tokens"]) == 2 * (24 - ts.cfg.frontend_len)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_decode_and_greedy_tokens_match(pair, paged):
    """Prefill of patches + text and decode steps (positions counting the
    patches) against the reference, then 8 greedy tokens with the weight
    cache on and off."""
    js, ts = pair
    batch = _batch(js.cfg)
    jh = js.serve(3, 32, paged=paged, weight_cache=False)
    th = ts.serve(3, 32, paged=paged, weight_cache=False)
    jl = np.asarray(jh.prefill(jax.tree.map(jnp.asarray, batch)))
    np.testing.assert_allclose(th.prefill(batch).numpy(), jl, atol=TOL, rtol=TOL)
    assert int(th.cache["pos"][0, 0]) == js.cfg.frontend_len + 10
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(3):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        tok = np.asarray(jt)
    for wc in (True, False):
        jo = js.serve(3, 32, paged=paged, weight_cache=wc).generate(
            jax.tree.map(jnp.asarray, batch), 8)
        to = ts.serve(3, 32, paged=paged, weight_cache=wc).generate(batch, 8)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), f"weight_cache={wc}")


def test_vlm_refusals(pair):
    """A vlm pool keeps the reference's refusal (its frontend needs more than
    a token prompt at admission).  Conversion, fine-tuning and squeezing
    run (``tests/test_torch_vlm_lifecycle.py`` holds them against the
    reference)."""
    _, ts = pair
    with pytest.raises(NotImplementedError, match="ServePool supports"):
        ts.serve_pool(2, 32)

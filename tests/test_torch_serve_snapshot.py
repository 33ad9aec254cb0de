"""A serving handle keeps serving the weights it was built from, across
``Session.finetune``, as the reference's handle does.

The optimizers update the session's tensors in place, so the handle's
``init_serve`` snapshots (clones) every leaf it passes through.  Smoke
bert-base on the CPU, the same prompt before and after three fine-tuning
steps at a large rate (``lr=5e-2``): the old handle's prefill logits and
greedy tokens are bit-identical before and after, with the weight cache on
and off; a handle built after serves the new weights; and the old handle's
logits match the reference's old handle's to float32 tolerance (both sum
in f32 in another order: 2e-4, as ``tests/test_torch_train.py`` allows)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import layers as JL
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel

TOL = dict(atol=2e-4, rtol=2e-4)
TUNE = dict(steps=3, seq_len=8, batch_size=2, lr=5e-2)


def _weights():
    src = TModel.build(tconfigs.smoke_config("bert-base"), seed=7, device="cpu")
    return jax.tree.map(lambda t: np.array(t.detach()), src.tree())


def _port(tree):
    ts = TSession.init(tconfigs.smoke_config("bert-base"), device="cpu")
    load_jax_params(ts.model, tree)
    return ts


@pytest.mark.parametrize("weight_cache", [True, False])
def test_old_handle_keeps_its_weights_across_finetune(weight_cache):
    tree = _weights()
    ts = _port(tree)
    jcfg = jconfigs.smoke_config("bert-base")
    jcfg = dataclasses.replace(
        jcfg, mpo=JL.MPOConfig(**dataclasses.asdict(ts.cfg.mpo)))
    js = JSession(jcfg, jax.tree.map(jnp.asarray, tree))
    prompts = np.random.default_rng(0).integers(0, ts.cfg.vocab_size, (2, 8)).astype(np.int32)
    batch = {"tokens": prompts}

    old, jold = ts.serve(2, 24, weight_cache=weight_cache), js.serve(2, 24,
                                                                     weight_cache=weight_cache)
    logits0 = old.prefill(batch).numpy().copy()
    tokens0 = old.generate(batch, 6).numpy()
    jlogits0 = np.asarray(jold.prefill(batch))
    jold.reset()

    ts.finetune(**TUNE)
    js.finetune(**TUNE)
    old.reset()
    logits1 = old.prefill(batch).numpy()
    tokens1 = old.generate(batch, 6).numpy()
    jlogits1 = np.asarray(jold.prefill(batch))

    # the old handle: the same bits before and after, as the reference's
    np.testing.assert_array_equal(logits1, logits0)
    np.testing.assert_array_equal(tokens1, tokens0)
    np.testing.assert_array_equal(jlogits1, jlogits0)
    np.testing.assert_allclose(logits1, jlogits1, **TOL)

    # a handle built now serves the fine-tuned weights: those of a fresh
    # session loaded with them
    new = ts.serve(2, 24, weight_cache=weight_cache)
    assert new is not old
    logits2 = new.prefill(batch).numpy()
    assert np.abs(logits2 - logits0).max() > 1e-2
    tuned = jax.tree.map(lambda t: np.array(t.detach()), ts.model.tree())
    fresh = _port(tuned).serve(2, 24, weight_cache=weight_cache)
    np.testing.assert_array_equal(logits2, fresh.prefill(batch).numpy())

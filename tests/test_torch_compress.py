"""Error-feedback gradient compression (``repro_torch.optim.compress``) and
the training entry point (``repro_torch.launch.train``) against the JAX
package.

- ``ef_int8`` and ``ef_topk`` bit for bit against ``repro.optim.compress``
  on the same numpy gradients and residuals (top-k's drawn without ties in
  magnitude, so both pick the same entries).
- Error feedback is unbiased over time and top-k keeps exactly k entries
  (mirroring ``tests/test_parallel.py``).
- LFA under either compressor converges on the smoke model, and frozen
  leaves carry no error state (mirroring ``tests/test_system.py``).
- ``python -m repro_torch.launch.train --smoke --device cpu --steps 3
  --compress int8`` runs, on a mesh of one, and logs the loss a direct
  ``make_train_step`` + ``wrap_compression`` loop gives at its first step
  (the loop logs the first step and every tenth), to the printed digits.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as RCMP
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import lightweight
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models.model import build
from repro_torch.optim import optimizers, schedule
from repro_torch.optim.compress import CompressState, ef_int8, ef_topk, wrap_compression
from repro_torch.train.steps import TrainState, make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _draw(shape, seed, ties=True):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.normal(size=shape).astype(np.float32)
    n = int(np.prod(shape))        # distinct magnitudes, random signs and order
    mags = (np.arange(1, n + 1, dtype=np.float32) / n) * rng.uniform(0.5, 2.0)
    return (rng.permutation(mags) * rng.choice([-1, 1], size=n)).astype(np.float32).reshape(shape)


@pytest.mark.parametrize("shape", [(64,), (7, 33), (2, 5, 16)])
def test_ef_int8_bit_for_bit_against_the_reference(shape):
    g, e = _draw(shape, 0), 0.1 * _draw(shape, 1)
    for _ in range(3):                                  # carry the residual
        rd, re = RCMP.ef_int8(jnp.asarray(g), jnp.asarray(e))
        td, te = ef_int8(torch.from_numpy(g), torch.from_numpy(e))
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(te.numpy(), np.asarray(re))
        e = te.numpy()
    gb = torch.from_numpy(g).to(torch.bfloat16)          # a bf16 gradient widens first
    rd, re = RCMP.ef_int8(jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(e))
    td, te = ef_int8(gb, torch.from_numpy(e))
    np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(100,), (12, 40)])
def test_ef_topk_bit_for_bit_against_the_reference(shape, frac):
    g = _draw(shape, 2, ties=False)
    e = np.zeros(shape, np.float32)
    for _ in range(2):
        rd, re = RCMP.ef_topk(jnp.asarray(g), jnp.asarray(e), frac=frac)
        td, te = ef_topk(torch.from_numpy(g), torch.from_numpy(e), frac=frac)
        np.testing.assert_array_equal(td.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(te.numpy(), np.asarray(re))
        e = te.numpy()


def test_ef_int8_error_feedback_is_unbiased_over_time():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    err, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        sent, err = ef_int8(g, err)
        total = total + sent
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=0.02)


def test_ef_topk_sparsity():
    g = torch.arange(100, dtype=torch.float32)
    sent, err = ef_topk(g, torch.zeros_like(g), frac=0.1)
    assert int((sent != 0).sum()) == 10
    np.testing.assert_allclose((sent + err).numpy(), g.numpy(), atol=1e-6)


def _setup(compress=None):
    cfg = TC.smoke_config("qwen3-14b")
    model = build(cfg, device="cpu")
    params = model.tree()
    mask = lightweight.trainable_mask(params, mode="lfa")
    opt = optimizers.adamw(2e-3, mask=mask)
    if compress:
        opt = wrap_compression(opt, kind=compress, mask=mask)
    state = TrainState(params, opt.init(params))
    return model, state, make_train_step(model, opt), make_batch_fn(
        cfg, ShapeConfig("t", "train", 32, 4))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_lfa_converges(kind):
    _, state, step, bf = _setup(kind)
    losses = []
    for i in range(25):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in bf(i).items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, losses
    assert isinstance(state.opt_state, CompressState)
    err = state.opt_state.error
    # frozen (central) leaves carry no error state; trainable ones do
    assert err["layers"]["mlp"]["w_up"]["cores"]["central"] is None
    assert err["layers"]["mlp"]["w_up"]["cores"]["c0"] is not None


def test_launch_train_cli_matches_a_direct_loop():
    args = ["--arch", "qwen3-14b", "--smoke", "--device", "cpu", "--steps", "3",
            "--compress", "int8", "--batch", "4", "--seq-len", "32"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                       capture_output=True, text=True, cwd=ROOT, timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("[train] final loss"))
    # the same run, step by step, off any mesh: the CLI's schedule and seed
    cfg = TC.smoke_config("qwen3-14b")
    model = build(cfg, device="cpu")
    params = model.tree()
    mask = lightweight.trainable_mask(params, mode="lfa")
    opt = wrap_compression(optimizers.adamw(schedule.cosine_warmup(1e-3, warmup=1, total=3),
                                            mask=mask), kind="int8", mask=mask)
    state = TrainState(params, opt.init(params))
    step, bf = make_train_step(model, opt), make_batch_fn(cfg, ShapeConfig("cli", "train",
                                                                           32, 4))
    state, m = step(state, {k: torch.as_tensor(v) for k, v in bf(0).items()})
    assert line == f"[train] final loss {float(m['loss']):.4f}", (line, float(m["loss"]))
    assert "mesh={'data': 1, 'model': 1}" in r.stdout

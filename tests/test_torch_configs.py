"""The port's configurations against the JAX package's: every registered
config field by field, albert-base's one stored layer, LFA split and
compression ratio at full width (abstractly: no full-width weights are
drawn), gemma2's local window and the configurations whose attention width
``num_heads * head_dim`` is not ``d_model`` (mistral-nemo-12b's 32 x 128 on
5120, gemma2-27b's 32 x 128 on 4608, which ``scaled_down``'s 4 x 16 = 64 =
d_model hides) on smoke weights, and the lifecycle command on albert-base.

Float32 throughout, sums in another order across two frameworks: logits
within 1e-4 (as ``tests/test_torch_model.py``), greedy tokens identical."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import Session as JSession
from repro import configs as jconfigs
from repro.core import layers as JL
from repro.core import lightweight as JLW
from repro.models import model as JModel
from repro_torch import Session as TSession
from repro_torch import configs as tconfigs
from repro_torch.core import layers as TL
from repro_torch.core import lightweight as TLW
from repro_torch.core import squeeze as TSQ
from repro_torch.core.carry import load_jax_params
from repro_torch.models import model as TModel
from repro_torch.models import transformer as TT
from repro_torch.pipeline import cli

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TOL = 1e-4


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_config_equals_the_reference_field_by_field(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    assert dataclasses.asdict(tconfigs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))


def _meta_params(arch):
    with torch.device("meta"):
        return TT.init(torch.Generator(), tconfigs.get_config(arch))


def test_albert_base_one_stored_layer_and_lfa_counts_at_full_width():
    """albert-base stores one layer (``share_layers``) and its LFA split is
    the reference's: 284,020 of 702,836 parameters train."""
    jparams, _ = JL.split_annotations(jax.eval_shape(
        JModel.build(jconfigs.get_config("albert-base")).init, jax.random.PRNGKey(0)))
    params = _meta_params("albert-base")
    assert {leaf.shape[0] for leaf in TLW.leaves(params["layers"])} == {1}
    assert {leaf.shape[0] for leaf in jax.tree.leaves(jparams["layers"])} == {1}
    jc = JLW.count_trainable(jparams, JLW.trainable_mask(jparams, mode="lfa"))
    tc = TLW.count_trainable(params, TLW.trainable_mask(params, mode="lfa"))
    assert tc == jc == (284_020, 702_836)


def test_albert_base_compression_ratio_is_an_independent_count():
    """Eq. 5's rho of full-width albert-base equals a count of its one
    stored layer made from the configuration alone: each matrix's cores
    (``MPOSpec.num_params()``) over its I x J, the embedding included.  The
    reference's ``model_compression_ratio`` is not the oracle here: it reads
    a stacked core's ``shape[1]`` / ``shape[2]`` as the i/j legs
    (``repro/core/squeeze.py:199-208``), which for ``(L, d0, i, j, d1)``
    are d0 and i (ROADMAP.md, Queue 3 C)."""
    cfg = tconfigs.get_config("albert-base")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim
    mats = [(d, hd, "attn", False, True)] * 3 + [(hd, d, "attn", True, False),
                                                 (d, f, "ffn", False, True),
                                                 (f, d, "ffn", True, False),
                                                 (cfg.vocab_size, d, "embed", False, False)]
    num = den = 0
    for i, j, kind, si, so in mats:
        spec = TL.make_spec(cfg.mpo, i, j, kind, si, so)
        num += spec.num_params()
        den += i * j
    rho = TSQ.model_compression_ratio(_meta_params("albert-base"))
    assert rho == num / den
    assert round(rho, 4) == 0.0231


def _pair(tcfg, jcfg):
    """(reference Session, port Session) over the same smoke weights, drawn
    by the port and loaded into both through numpy."""
    tree = jax.tree.map(lambda t: np.array(t), TModel.build(tcfg, seed=7, device="cpu").tree())
    js = JSession(jcfg, jax.tree.map(jnp.asarray, tree))
    ts = TSession.init(tcfg, device="cpu")
    load_jax_params(ts.model, tree)
    return js, ts


def _assert_serving_matches(js, ts, prompts, paged, steps=4):
    """Teacher-forced logits, then prefill and ``steps`` decode steps (the
    reference's greedy tokens fed to both), then greedy generation."""
    jl, _ = js.model.forward(js.params, {"tokens": jnp.asarray(prompts)})
    with torch.no_grad():
        tl = ts.model({"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    b, s = prompts.shape
    jh = js.serve(b, 32, paged=paged, weight_cache=False)
    th = ts.serve(b, 32, paged=paged, weight_cache=False)
    jl = np.asarray(jh.prefill({"tokens": jnp.asarray(prompts)}))
    np.testing.assert_allclose(th.prefill({"tokens": prompts}).numpy(), jl, atol=TOL, rtol=TOL)
    tok = np.argmax(jl[:, -1], -1)[:, None].astype(np.int32)
    for _ in range(steps):
        jt, jl = jh.decode(jnp.asarray(tok))
        tt, tl = th.decode(tok)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
        tok = np.asarray(jt)
    for wc in (True, False):
        jo = js.serve(b, 32, paged=paged, weight_cache=wc).generate(
            {"tokens": jnp.asarray(prompts)}, steps)
        to = ts.serve(b, 32, paged=paged, weight_cache=wc).generate(
            {"tokens": prompts}, steps)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _prompts(cfg, b=2, s=14, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_gemma2_local_window_matches_reference_and_binds(paged):
    """A 4-token window on gemma2's even (local) layers, 14-token prompts:
    prefill masks and decode's flash bias both cut keys; the port matches
    the reference, and its logits differ from global-only attention's (as
    ``tests/test_models_smoke.py`` asks of the reference)."""
    kw = dict(num_layers=2, local_window=4)
    js, ts = _pair(tconfigs.smoke_config("gemma2-27b", **kw),
                   jconfigs.smoke_config("gemma2-27b", **kw))
    prompts = _prompts(ts.cfg)
    _assert_serving_matches(js, ts, prompts, paged)
    glob = TSession.init(dataclasses.replace(ts.cfg, local_window=None), device="cpu")
    glob.model.set_tree(ts.params)
    with torch.no_grad():
        local = ts.model({"tokens": torch.from_numpy(prompts)})[:, -1]
        full = glob.model({"tokens": torch.from_numpy(prompts)})[:, -1]
    assert not torch.allclose(local, full, atol=1e-3)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma2-27b"])
@pytest.mark.parametrize("paged", [False, True])
def test_attention_wider_than_d_model_matches_reference(arch, paged):
    """``num_heads * head_dim`` != ``d_model``, as at full width: 4 heads of
    32 (128) on a 64-wide residual stream, wq/wk/wv 64 -> 128 / 64 and wo
    128 -> 64."""
    kw = dict(num_layers=2, head_dim=32)
    js, ts = _pair(tconfigs.smoke_config(arch, **kw), jconfigs.smoke_config(arch, **kw))
    attn = ts.params["layers"]["attn"]
    i_wo = int(np.prod([c.shape[-3] for c in TL.cores_to_list(attn["wo"]["cores"])]))
    assert ts.cfg.num_heads * ts.cfg.head_dim == i_wo == 128 != ts.cfg.d_model
    _assert_serving_matches(js, ts, _prompts(ts.cfg), paged)


def test_pipeline_cli_runs_albert_base_cls_squeeze(capsys):
    """``repro-torch-pipeline --arch albert-base --cls --squeeze --device
    cpu``: fine-tune, squeeze, and the stage report as JSON."""
    assert cli.main(["--arch", "albert-base", "--cls", "--squeeze", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    report = json.loads("\n".join(lines[lines.index("{"):]))
    assert report["arch"] == "albert-base" and report["task"] == "cls"
    assert [s["stage"] for s in report["stages"]] == ["init", "finetune", "squeeze"]
    assert report["squeeze_events"] >= 1
    assert report["stages"][-1]["rho_after"] < report["stages"][-1]["rho_before"]

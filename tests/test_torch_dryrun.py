"""The port's dry run (``repro_torch.launch.dryrun``), its op counter
(``launch.op_analysis``, the counterpart of ``launch.hlo_analysis``) and
its roofline (``launch.roofline``), on the CPU: fake process groups and fake
tensors, nothing allocated, no card.

- The op counter: a known matmul's 2·m·n·k FLOPs, its operand and output
  bytes, the bytes every non-view output writes, the peak of live bytes,
  and a known all-reduce's / all-gather's bytes under a fake process group.
- The roofline's arithmetic, as ``tests/test_dryrun_roofline.py`` holds the
  reference's, at the H100's peaks.
- The dry run's own invariants at smoke bert-base (a tensor-parallel
  layout): its (1, 1) matmul FLOPs equal ``FlopCounterMode`` of the same
  step run unsharded; collective bytes are 0 at (1, 1) and above 0 at
  (1, 4); rank 0's peak and matmul FLOPs at (1, 4) are below (1, 1)'s.
  (The reference's own dry-run test fails on every run, ROADMAP.md Queue 3
  D, so the port is held to these instead of to its output.)
- A production-mesh cell (16 x 16 ranks) runs; every family runs at
  (1, 4), a MoE cell's collective bytes counting the all-reduce of each
  layer's combine over ``model``; the CLI writes records.
"""

import json

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import roofline as RL

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

TRAIN = ShapeConfig("t", "train", 32, 8)


def test_matmul_flops_bytes_and_peak():
    with FakeTensorMode():
        x, w = torch.empty(64, 128), torch.empty(128, 32)
        y, c = OA.analyze(lambda a, b: (a @ b).t().relu(), x, w)
        a, b = torch.empty(3, 16, 8, dtype=torch.bfloat16), torch.empty(3, 8, 4,
                                                                        dtype=torch.bfloat16)
        _, cb = OA.analyze(torch.bmm, a, b)
    assert y.shape == (32, 64)
    assert c["flops"] == 2 * 64 * 128 * 32 and c["flops_by_op"] == {"aten.mm": 2 * 64 * 128 * 32}
    assert c["matmul_bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert c["bytes_written"] == 4 * 2 * 64 * 32            # mm and relu; the transpose is a view
    assert c["peak_bytes"] == 4 * (64 * 128 + 128 * 32 + 2 * 64 * 32)
    assert c["collective_bytes"] == dict.fromkeys(OA.COLLECTIVES, 0)
    assert cb["flops"] == 2 * 3 * 16 * 8 * 4 and cb["matmul_bytes"] == 2 * 3 * (128 + 32 + 64)


def test_collective_bytes_under_a_fake_world():
    def step(t):
        dist.all_reduce(t)
        parts = [torch.empty(10) for _ in range(4)]
        dist.all_gather(parts, torch.empty(10))
        return funcol.all_reduce(torch.empty(100), "sum", dist.group.WORLD) + 1

    with D.fake_world(4), FakeTensorMode():
        _, c = OA.analyze(step, torch.empty(1000, dtype=torch.bfloat16))
    assert not dist.is_initialized()
    assert c["collective_bytes"] == {"all-gather": 4 * 10 * 4, "all-reduce": 2000 + 400,
                                     "reduce-scatter": 0, "all-to-all": 0}
    assert c["bytes_written"] == 4 * 4 * 10 + 4 * 10 + 4 * 100 + 4 * 100   # empties and the add


def test_roofline_terms_math():
    peak = RL.PEAK_FLOPS["bfloat16"]
    rec = {"devices": 256, "dtype": "bfloat16",
           "flops_per_device": peak,                  # exactly 1 s of compute
           "bytes_per_device": RL.HBM_BW,             # exactly 1 s of HBM
           "collective_bytes": {"all-gather": RL.NVLINK_BW / 2, "all-reduce": RL.NVLINK_BW / 2},
           "model_flops": peak * 128,                 # half the fleet's peak-second
           "model_flops_dense": peak * 256}
    out = RL.roofline(rec)
    assert out["compute_s"] == pytest.approx(1.0)
    assert out["memory_s"] == pytest.approx(1.0)
    assert out["collective_s"] == pytest.approx(1.0)
    assert out["step_s"] == pytest.approx(1.0)
    assert out["roofline_fraction"] == pytest.approx(0.5)
    assert out["roofline_fraction_dense_equiv"] == pytest.approx(1.0)
    assert out["useful_flops_ratio"] == pytest.approx(0.5)
    f32 = RL.roofline(dict(rec, dtype="float32", bytes_per_device=0, collective_bytes={}))
    assert f32["compute_s"] == pytest.approx(peak / 67e12) and f32["dominant"] == "compute_s"
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW) == (
        {"bfloat16": 989e12, "float32": 67e12}, 3.35e12, 450e9)


def test_active_params_and_model_flops():
    from repro_torch.analysis.sharding_lint import abstract_params
    from repro_torch.core import lightweight
    cfg = configs.get_config("bert-base")
    assert RL.active_param_count(cfg) == lightweight.count_params(abstract_params(cfg)[0])
    moe = configs.get_config("phi3.5-moe-42b-a6.6b")
    assert RL.active_param_count(moe) < lightweight.count_params(abstract_params(moe)[0])
    assert D.model_flops(TRAIN, 10) == 6.0 * 10 * 8 * 32
    assert D.model_flops(SHAPES["decode_32k"], 10) == 2.0 * 10 * 128


@pytest.fixture(scope="module")
def cells():
    """Smoke bert-base's LFA step, one rank of (1, 1), (1, 4) and (2, 2)."""
    return {ms: D.run_cell("bert-base", TRAIN, mesh_shape=ms, smoke=True, verbose=False)
            for ms in ((1, 1), (1, 4), (2, 2))}


def test_dryrun_flops_equal_the_unsharded_count(cells):
    cfg = configs.smoke_config("bert-base")
    with FakeTensorMode():
        step, args, _ = D.build_step(cfg, TRAIN, None)
        with FlopCounterMode(display=False) as fc:
            step(*args)
    assert cells[(1, 1)]["flops_per_device"] == fc.get_total_flops() > 0


def test_collectives_only_across_ranks(cells):
    assert not any(cells[(1, 1)]["collective_bytes"].values())
    for ms in ((1, 4), (2, 2)):
        coll = cells[ms]["collective_bytes"]
        assert coll["all-gather"] > 0 and coll["all-reduce"] > 0, ms
    assert cells[(2, 2)]["collective_bytes"]["reduce-scatter"] > 0    # FSDP gathers' backward


def test_per_rank_work_falls_with_the_model_axis(cells):
    one, four = cells[(1, 1)], cells[(1, 4)]
    assert four["peak_bytes_per_device"] < one["peak_bytes_per_device"]
    assert four["flops_per_device"] < one["flops_per_device"]
    for rec in cells.values():
        assert rec["sharding_lint"]["errors"] == 0 and rec["dtype"] == "float32"
        assert rec["step_s"] == max(rec["compute_s"], rec["memory_s"], rec["collective_s"])
        assert rec["model_flops"] == D.model_flops(TRAIN, RL.active_param_count(
            configs.smoke_config("bert-base")))


def test_production_mesh_and_serving_cells():
    rec = D.run_cell("bert-base", "decode_32k", smoke=True, verbose=False)
    assert (rec["mesh"], rec["devices"], rec["kind"]) == ("16x16", 256, "decode")
    assert rec["flops_per_device"] > 0 and rec["sharding_lint"]["errors"] == 0
    pre = D.run_cell("mamba2-130m", ShapeConfig("p", "prefill", 64, 4), mesh_shape=(2, 2),
                     smoke=True, verbose=False)
    assert pre["flops_per_device"] > 0 and pre["kind"] == "prefill"


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "llava-next-34b", "zamba2-7b",
                                  "whisper-tiny"])
def test_dryrun_runs_every_family(arch, monkeypatch):
    """The LFA step of every family at (1, 4): counted, lint-clean.  The
    moe cell's all-reduce bytes hold the combine's sum over ``model``, one
    (B, S, D) float32 a MoE layer (``models.moe.apply_moe`` reduces it),
    and its all-gather bytes the router table's gather, one a layer."""
    import sys

    from repro_torch.parallel import spmd
    combines, tables = [], []
    reduce, gather = spmd.reduce, spmd.gather

    def spy(x, mesh, name="model"):
        if sys._getframe(1).f_code.co_name == "apply_moe":
            combines.append(x.numel() * x.element_size())
        return reduce(x, mesh, name)

    def spy_gather(x, dim, mesh, name="model"):
        if sys._getframe(1).f_code.co_name == "_whole_table":
            tables.append(x.numel() * x.element_size())
        return gather(x, dim, mesh, name)

    monkeypatch.setattr(spmd, "reduce", spy)
    monkeypatch.setattr(spmd, "gather", spy_gather)
    rec = D.run_cell(arch, TRAIN, mesh_shape=(1, 4), smoke=True, verbose=False)
    assert "skipped" not in rec and rec["flops_per_device"] > 0
    assert rec["sharding_lint"]["errors"] == 0 and rec["step_s"] > 0
    cfg = configs.smoke_config(arch)
    if cfg.family == "moe":
        assert combines == [TRAIN.global_batch * TRAIN.seq_len * cfg.d_model * 4] * \
            cfg.num_layers
        assert rec["collective_bytes"]["all-reduce"] >= sum(combines)
        # each rank's (D, E/4) block of the (D, E) table
        assert tables == [cfg.d_model * cfg.num_experts // 4 * 4] * cfg.num_layers
        assert rec["collective_bytes"]["all-gather"] >= 4 * sum(tables)
    else:
        assert combines == tables == []


def test_dryrun_cli(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    assert D.main(["--arch", "bert-base", "--shape", "prefill_32k", "--mesh", "1x2", "--smoke",
                   "--out", str(out)]) == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["mesh"] == "1x2" and rec["devices"] == 2 and rec["flops_per_device"] > 0
    assert "1/1 cells OK" in capsys.readouterr().out

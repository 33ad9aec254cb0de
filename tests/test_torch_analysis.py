"""The port's static analysis (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``), and one seeded violation per detector.

- The sharding findings (check, severity, config, mesh, location) equal the
  reference's ``lint_sharding`` for every config at each of
  ``DEFAULT_MESHES`` (leaf paths are spelled alike: dict keys joined by
  ``/``); a ``Finding`` fingerprints alike in both packages and a baseline
  written by either suppresses in the other.
- Seeded violations, as ``tests/test_analysis.py`` seeds the reference's:
  the raw ``make_rules`` table (head-safety), a data-sharded norm vector
  and an unknown axis (small-leaf, coverage), an indivisible dim
  (divisibility), a gate admitting an over-budget tile (smem-budget), a bad
  tile constant (alignment), a page read past the pool (page-bounds), a
  drifted cache leaf, a step that calls ``.item()`` (host-transfer), a
  dtype-drifted logit (phase-drift).
- Clean runs: sharding and kernel at every config and mesh; the trace
  family at full width on fake tensors for bert-base, mamba2-130m,
  llama4-maverick (moe) and whisper-tiny.
- ``repro-torch-lint``'s gate, baseline and ``--json``;
  ``Session.report()["analysis"]`` and ``repro-torch-pipeline
  --strict-analysis``; the compiler-report parser (and, on the card, the
  report of a real build).
"""

import json

import pytest
import torch

from repro import configs as RC
from repro.analysis import findings as RF
from repro.analysis import sharding_lint as RSL
from repro_torch import configs
from repro_torch.analysis import cli as LC
from repro_torch.analysis import findings as F
from repro_torch.analysis import kernel_budget as KB
from repro_torch.analysis import trace_lint as TL
from repro_torch.analysis.sharding_lint import (DEFAULT_MESHES, SHARDING_FILE, MeshSpec,
                                                abstract_params, lint_sharding)
from repro_torch.kernels import mpo_linear as MK
from repro_torch.parallel import sharding as S

torch.set_num_threads(1)   # pytest -n runs a test process a core: one intra-op thread each

ARCHS = sorted(configs.ARCHS)
QWEN = configs.get_config("qwen3-14b")


def _ident(f):
    return (f.check, f.severity, f.config, f.mesh, f.location)


# ------------------------------------------------------------ sharding


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_findings_match_reference(arch):
    for rmesh, tmesh in zip(RSL.DEFAULT_MESHES, DEFAULT_MESHES):
        assert rmesh.describe() == tmesh.describe()
        ref = sorted(map(_ident, RSL.lint_sharding(RC.get_config(arch), rmesh)))
        got = sorted(map(_ident, lint_sharding(configs.get_config(arch), tmesh)))
        assert got == ref, (arch, tmesh.describe())
        assert not [f for f in got if f[1] == "error"]


def test_finding_fingerprint_and_baseline_cross_packages(tmp_path):
    kw = dict(check="sharding/head-safety", severity="error", location="rules['qkv']",
              message="m", config="qwen3-14b", mesh="data=1,model=16")
    port = F.Finding(file=SHARDING_FILE, **kw)
    ref = RF.Finding(file=RSL.SHARDING_FILE, **dict(kw, message="another message"))
    assert port.fingerprint == ref.fingerprint
    assert port.format().startswith("ERROR   sharding/head-safety [qwen3-14b,data=1,model=16]")
    # written by either package, read by the other
    F.save_baseline(str(tmp_path / "port.json"), [port])
    RF.save_baseline(str(tmp_path / "ref.json"), [ref])
    assert RF.new_findings([ref], RF.load_baseline(str(tmp_path / "port.json"))) == []
    assert F.new_findings([port], F.load_baseline(str(tmp_path / "ref.json"))) == []
    # a stale or malformed baseline suppresses nothing
    (tmp_path / "bad.json").write_text("{not json")
    assert F.new_findings([port], F.load_baseline(str(tmp_path / "bad.json"))) == [port]


def test_seeded_head_safety_violation_raw_rules():
    mesh = MeshSpec({"data": 1, "model": 16})
    assert QWEN.num_heads % 16 != 0                    # the seed's premise
    found = lint_sharding(QWEN, mesh, rules=S.make_rules(mesh))
    errs = [f for f in found if f.check == "sharding/head-safety"]
    assert errs and all(f.severity == "error" and f.file == SHARDING_FILE for f in errs)
    assert {f.location for f in errs} == {"rules['qkv']", "rules['kv_qkv']"}
    assert not [f for f in lint_sharding(QWEN, mesh) if f.check == "sharding/head-safety"]


def test_seeded_small_leaf_and_coverage():
    mesh = MeshSpec({"data": 2, "model": 4})
    shapes = {"norm": torch.empty(8, device="meta"), "w": torch.empty(16, 16, device="meta")}
    axes = {"norm": ("embed",), "w": ("mystery_axis", "ffn")}
    found = lint_sharding(QWEN, mesh, rules={"embed": ("data",), "ffn": ("model",)},
                          shapes=shapes, axes=axes)
    small = [f for f in found if f.check == "sharding/small-leaf"]
    cover = [f for f in found if f.check == "sharding/coverage"]
    assert [(f.severity, f.location) for f in small] == [("error", "norm")]
    assert [(f.severity, f.location) for f in cover] == [("error", "w")]
    assert "mystery_axis" in cover[0].message


def test_divisibility_fallback_is_a_warning():
    mesh = MeshSpec({"data": 1, "model": 4})
    found = lint_sharding(QWEN, mesh, rules={"ffn": ("model",)},
                          shapes={"w": torch.empty(10, 16, device="meta")},
                          axes={"w": ("ffn", None)})
    div = [f for f in found if f.check == "sharding/divisibility"]
    assert len(div) == 1 and div[0].severity == "warning"
    assert "10" in div[0].message and div[0].location == "w[dim 0]"
    # bert-base's first-core legs at 1x4: the real trees give such warnings too
    bert = lint_sharding(configs.get_config("bert-base"), mesh)
    assert {f.check for f in bert} == {"sharding/divisibility"}


def test_lint_cli_every_config_at_1x4_gives_no_error(capsys):
    """``repro-torch-lint --meshes 1x4 --families sharding`` over every
    config, the moe, vlm, hybrid and encdec families among them: no error
    and no info (every family runs on a mesh; none is only linted)."""
    assert LC.main(["--meshes", "1x4", "--families", "sharding"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out and "0 info" in out and f"{len(ARCHS)} config(s)" in out


def test_abstract_params_match_the_model_on_meta():
    shapes, axes = abstract_params(configs.get_config("bert-base"))
    flat = dict(TL._flat(shapes))
    assert all(t.device.type == "meta" for t in flat.values())
    assert set(flat) == set(TL._flat(axes))


# ------------------------------------------------------------ kernel budgets


def _big_f32_shapes():
    """A float32 core shape set of the configs whose tensor-core plan
    refuses its largest row tile for shared memory."""
    for arch in ARCHS:
        for shapes in sorted(KB.core_shape_sets(abstract_params(configs.get_config(arch))[0])):
            if MK.forward_kernel(shapes, "float32") == "mma" and \
                    MK.forward_plan(shapes, 2048, "float32", 128) is None:
                return shapes
    raise AssertionError("no such shape set")


def test_seeded_overbudget_tile_reported():
    shapes = _big_f32_shapes()
    admits_all = lambda shapes, bm, *, dtype, m: True
    found = KB.lint_mpo_call(shapes, dtype="float32", config="seeded",
                             eligible_fn=admits_all)
    errs = [f for f in found if f.check == "kernel/smem-budget" and f.severity == "error"]
    assert errs and all(f.file == KB.MPO_FILE for f in errs)
    assert any("mma@block_m=128" in f.location for f in errs)
    assert all(KB.forward_smem(shapes, "float32", 128, 2048) > KB.SMEM_LIMIT for _ in errs)
    # the real gate admits no such tile
    assert not [f for f in KB.lint_mpo_call(shapes, dtype="float32")
                if f.severity == "error"]
    # a plan's own shared memory is what forward_smem reads
    plan = MK.forward_plan(shapes, 2048, "float32", 64)
    assert KB.forward_smem(shapes, "float32", 64, 2048) == plan.smem


def test_seeded_bad_tile_constants():
    assert KB.lint_constants() == []
    assert KB.dispatched_tiles("mma") == set(MK.MMA_BM)
    assert KB.dispatched_tiles("cuda_core") == set(MK.NARROW_BM)
    bad = KB.lint_constants(mma_bm=(16, 64, 120))
    locs = {f.location for f in bad}
    assert all(f.check == "kernel/tile-alignment" and f.severity == "error" for f in bad)
    assert {"TILES['mma']", "mma@block_m=120", "mpo_linear_mma.cu:dispatch"} <= locs
    assert KB.lint_constants(dispatched={"mma": {16, 64}, "cuda_core": {64, 128}})


def test_flash_page_reads_and_seeded_read_past_the_pool():
    # the split kernel's walk: every mapped page once, in split order
    reads = KB.flash_page_reads(40, list(range(16)), 16, 16, 16, 4)
    assert [(s, p) for s, p, _, _ in reads] == [(1, 0), (2, 1), (3, 2)]
    assert KB.flash_page_reads(0, [-1] * 16, 16, 16, 16, 2) == []
    clean = KB.lint_decode_attention_call(8, 4, 128, 16, 16, config="x")
    assert not [f for f in clean if f.severity != "info"]

    def unclamped(length, table, ps, mp, pool, splits):   # one page too many, no clamp
        np_ = min(-(-max(length, 0) // ps) + 1, mp + 1)
        return [(0, p, table[p] if p < mp else -1, table[p] if p < mp else pool)
                for p in range(np_)]

    def shifted(length, table, ps, mp, pool, splits):     # each page reads the next entry
        return [(s, p, table[min(p + 1, mp - 1)], max(table[min(p + 1, mp - 1)], 0))
                for s, p, _, _ in KB.flash_page_reads(length, table, ps, mp, pool, splits)]

    for fn, what in ((unclamped, "outside"), (shifted, "unmapped")):
        found = KB.lint_decode_attention_call(8, 4, 128, 16, 16, config="x", reads_fn=fn)
        bounds = [f for f in found if f.check == "kernel/page-bounds"]
        assert bounds and all(f.severity == "error" and f.file == KB.DA_FILE for f in bounds)
        assert all(what in f.message for f in bounds), what
    # a tight budget turns the split kernel's shared memory into an error
    tight = KB.lint_decode_attention_call(8, 4, 128, 16, 16, budget=1024)
    assert [f for f in tight if f.check == "kernel/smem-budget" and f.severity == "error"]


def test_ssd_budget():
    m = configs.get_config("mamba2-130m")
    assert KB.lint_ssd_call(m.ssm_heads, m.ssm_head_dim, m.ssm_state, m.ssm_chunk,
                            dtype="bfloat16") == []
    over = KB.lint_ssd_call(24, 64, 256, 128, dtype="bfloat16")
    assert [(f.check, f.severity) for f in over] == [("kernel/smem-budget", "error")]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110mma_kernelIfLi128ELi4EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110mma_kernelIfLi128ELi4EEEvNS_4ArgsE
    0 bytes stack frame, 188 bytes spill stores, 184 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110mma_kernelI13__nv_bfloat16Li64ELi2EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110mma_kernelI13__nv_bfloat16Li64ELi2EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_report_parsed():
    recs = KB.parse_ptxas(PTXAS_LOG)
    assert sorted(r["registers"] for r in recs.values()) == [128, 168]
    assert sorted(r["spill_stores"] for r in recs.values()) == [0, 188]
    src = (KB._build.CSRC / "mpo_linear_mma.cu").read_text()
    threads = KB.block_threads(src)
    assert threads["suffix_kernel"] == 256 and threads["mma_kernel"]([128, 4]) == 512
    found = KB.register_findings("mpo_linear_mma", PTXAS_LOG, src)
    by = {(f.location, f.severity): f for f in found}
    # 128 x 512 = 65536 fits; 168 x 256 fits; the bf16 kernel at 64 rows
    assert ("mpo_linear_mma:mma_kernel<float,128,4>", "warning") in by        # the spill
    assert "1 block(s)" in by[("mpo_linear_mma:mma_kernel<float,128,4>", "info")].message
    assert ("mpo_linear_mma:mma_kernel<__nv_bfloat16,64,2>", "error") not in by
    # more registers than an SM holds for the block (136 x 512 threads at 128
    # rows), or than a thread may have: errors
    hot = PTXAS_LOG.replace("Used 128 registers", "Used 136 registers")
    errs = [f for f in KB.register_findings("mpo_linear_mma", hot, src) if f.severity == "error"]
    assert [f.location for f in errs] == ["mpo_linear_mma:mma_kernel<float,128,4>"]
    hot = PTXAS_LOG.replace("Used 168 registers", "Used 300 registers")
    errs = [f for f in KB.register_findings("mpo_linear_mma", hot, src) if f.severity == "error"]
    assert [f.location for f in errs] == ["mpo_linear_mma:mma_kernel<__nv_bfloat16,64,2>"]
    # never builds: a library without a log reports nothing here
    assert KB.lint_registers(["no_such_kernel"]) == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compiler's report exists only where the "
                    "kernels are built (run on the H100 with `python -m pytest -q -m cuda "
                    "tests/test_torch_analysis.py`)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_register_report_of_a_build(cuda):
    KB._build.build()
    found = KB.lint_registers()
    assert not [f for f in found if f.severity == "error"], found
    infos = {f.location.split(":")[0] for f in found if f.severity == "info"}
    assert infos == set(KB._build.sources())


# ------------------------------------------------------------ traces


def test_seeded_cache_drift():
    cache_in = {"k": torch.empty(2, 8, dtype=torch.bfloat16, device="meta"),
                "pos": torch.empty(2, dtype=torch.int32, device="meta")}
    cache_out = dict(cache_in, k=torch.empty(2, 8, dtype=torch.float32, device="meta"))
    (f,) = TL.cache_drift_findings(TL.cache_specs(cache_in), TL.cache_specs(cache_out),
                                   config="seeded")
    assert (f.check, f.severity, f.location) == ("trace/cache-drift", "error",
                                                 "decode:cache/k")
    found = TL.cache_drift_findings(TL.cache_specs(cache_in),
                                    TL.cache_specs({"pos": cache_in["pos"]}), config="seeded")
    assert [f.location for f in found] == ["decode:cache/k"]
    assert TL.cache_specs(cache_in)["k"] == ((2, 8), torch.bfloat16, "meta")
    assert TL.cache_drift_findings(TL.cache_specs(cache_in), TL.cache_specs(cache_in),
                                   config="x") == []


def test_seeded_host_transfer():
    from torch._subclasses.fake_tensor import FakeTensorMode

    def step(x):                       # a hot loop that reads a value on the host
        return x * (x.sum().item() + 1)

    with FakeTensorMode():
        x = torch.empty(4, 4)
        out, mode = TL.run_step(step, x)
    assert out.shape == (4, 4)
    (f,) = TL.host_transfer_findings(mode, config="seeded", phase="decode")
    assert (f.check, f.severity, f.location) == ("trace/host-transfer", "warning",
                                                 "decode:step")
    assert "_local_scalar_dense" in f.message and mode.transfers() == {"syncs": 1,
                                                                         "copies": 0}
    # on real tensors too, with a copy across devices counted apart
    _, mode = TL.run_step(lambda t: t.to("meta"), torch.ones(3))
    assert mode.transfers() == {"syncs": 0, "copies": 1}


def test_seeded_phase_drift():
    (f,) = TL.phase_drift_findings(torch.bfloat16, torch.float32, config="seeded")
    assert (f.check, f.severity) == ("trace/phase-drift", "warning")
    assert TL.phase_drift_findings(torch.float32, torch.float32, config="x") == []


@pytest.mark.parametrize("arch", ["bert-base", "mamba2-130m", "llama4-maverick-400b-a17b",
                                  "whisper-tiny"])
def test_trace_lint_clean_at_full_width(arch):
    cfg = configs.get_config(arch)
    found = TL.lint_traces(cfg)
    assert [f.check for f in found] == ["trace/ops"], [f.format() for f in found]
    assert found[0].severity == "info" and "aten." in found[0].message
    tcfg = TL.trace_config(cfg)
    assert (tcfg.d_model, tcfg.num_heads, tcfg.dtype) == (cfg.d_model, cfg.num_heads, cfg.dtype)


def test_decode_transfers_counted():
    cfg = configs.smoke_config("bert-base")
    assert TL.decode_transfers(cfg, paged=True, batch=2, prompt=8, max_len=32) == \
        {"syncs": 0, "copies": 0}


# ------------------------------------------------------------ sweeps and CLIs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_and_kernel_clean_every_config_and_mesh(arch):
    found = LC.run_lint([arch], DEFAULT_MESHES, {"sharding", "kernel"})
    assert not [f.format() for f in found if f.severity == "error"]


def test_lint_cli_gate_baseline_and_json(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    args = ["--configs", "bert-base", "--families", "sharding,kernel"]
    assert LC.main(args + ["-q"]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    assert LC.main(args + ["--fail-on", "warning", "-q"]) == 1     # divisibility warnings
    base = str(tmp_path / "base.json")
    assert LC.main(args + ["--write-baseline", base]) == 0
    capsys.readouterr()
    assert LC.main(args + ["--fail-on", "warning", "--baseline", base, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["summary"]["errors"] == 0 and payload["summary"]["suppressed"] > 0
    assert all(not f["new"] and len(f["fingerprint"]) == 16 for f in payload["findings"])
    # a seeded error fails the gate, and the baseline takes it in
    seeded = F.Finding(check="kernel/smem-budget", severity="error", file=KB.MPO_FILE,
                       location="seeded", message="m", config="bert-base")
    monkeypatch.setattr(LC, "lint_kernels", lambda cfg, budget: [seeded])
    assert LC.main(args + ["-q"]) == 1
    assert LC.main(args + ["--write-baseline", base]) == 0
    assert LC.main(args + ["--baseline", base, "-q"]) == 0


def test_autotune_substrates_reported(tmp_path):
    from repro_torch.kernels import autotune
    ent = {"mode": "factorized", "block_m": 0}
    cpu_key = autotune.make_key([(1, 4, 4, 1)], 8, "train", "float32")
    card_key = ("device=NVIDIA H100 80GB HBM3|cc=9.0|torch=0.0|cuda=12.0"
                "|shapes=1x4x4x1|tokens=8|phase=train|dtype=bfloat16")
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"version": autotune.CACHE_VERSION,
                                "entries": {cpu_key: ent, card_key: ent}}))
    found = LC.autotune_findings(str(path))
    assert len(found) == 2 and all(f.severity == "info" for f in found)
    cpu = next(f for f in found if "device=cpu" in f.location)
    card = next(f for f in found if "H100" in f.location)
    assert "CPU-measured" in cpu.message and "CPU-measured" not in card.message
    assert "will not answer lookups" in card.message


def test_session_report_and_strict_analysis(monkeypatch, capsys):
    from repro_torch.analysis import session as AS
    from repro_torch.pipeline import cli as PC
    from repro_torch.pipeline.session import Session
    sess = Session.init("bert-base", device="cpu")
    ana = sess.report()["analysis"]
    assert ana["clean"] and ana["errors"] == 0 and "error" not in ana
    assert ana["meshes"] == ["data=1,model=1", "data=1,model=4", "data=2,model=4"]
    argv = ["--arch", "bert-base", "--cls", "--steps", "1", "--tokens", "0", "--device", "cpu",
            "--strict-analysis"]
    assert PC.main(argv) == 0
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["analysis"]["clean"]
    seeded = F.Finding(check="kernel/smem-budget", severity="error", file=KB.MPO_FILE,
                       location="seeded", message="m", config="bert-base")
    monkeypatch.setattr(AS, "lint_kernels", lambda cfg, shapes_tree: [seeded])
    assert sess.report()["analysis"]["errors"] == 1
    assert PC.main(argv) == 1
    assert PC.main(argv[:-1]) == 0                  # without the flag: a report, exit 0
    # an analysis that raises shows as an error entry, never breaks the report
    monkeypatch.setattr(AS, "lint_kernels", lambda cfg, shapes_tree: 1 / 0)
    assert "ZeroDivisionError" in sess.report()["analysis"]["error"]


def test_kernel_lint_reads_live_core_shapes():
    """A session's squeezed bonds are re-checked: the kernel lint walks the
    live tree's core shapes, stacked dims dropped."""
    cores = {"c0": torch.empty(12, 1, 4, 4, 3, device="meta"),
             "central": torch.empty(12, 3, 4, 4, 1, device="meta")}
    assert KB.core_shape_sets({"a": {"w": {"cores": cores}}}) == {((1, 4, 4, 3), (3, 4, 4, 1))}

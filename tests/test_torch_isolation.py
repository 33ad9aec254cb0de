"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_import_statements():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad
    assert len(_port_files()) > 15
    # the conversion, squeezing, persistence and serving front-end modules,
    # the encdec family's, the autotuner, the mesh modules, the static
    # analysis and the dry run are among the files checked
    names = {p.relative_to(PORT).as_posix() for p in _port_files() if PORT in p.parents}
    assert {"core/convert.py", "core/squeeze.py", "core/mpo.py", "checkpoint/manager.py",
            "resilience/faults.py", "resilience/journal.py", "resilience/state.py",
            "pipeline/clock.py", "pipeline/scheduler.py", "pipeline/traffic.py",
            "pipeline/router.py", "pipeline/cli.py", "models/whisper.py",
            "configs/whisper_tiny.py", "kernels/autotune.py", "parallel/sharding.py",
            "parallel/ctx.py", "parallel/spmd.py", "launch/mesh.py", "launch/train.py",
            "optim/compress.py", "analysis/__init__.py", "analysis/findings.py",
            "analysis/sharding_lint.py", "analysis/kernel_budget.py", "analysis/trace_lint.py",
            "analysis/session.py", "analysis/cli.py", "launch/op_analysis.py",
            "launch/roofline.py", "launch/dryrun.py"} <= names


def test_importing_the_port_loads_no_jax_or_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = "\n".join(
        ["import importlib, sys",
         f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
         f"for m in {modules!r}: importlib.import_module(m)",
         "import chip_smoke",
         "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]",
         "assert not bad, bad",
         "print(len(sys.modules))"])
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr

"""Import isolation, top-level module names compared whole: nothing the
harness loads for a cell is JAX or the JAX package (``e4s_tpu_torch`` is
allowed, ``e4s_tpu`` is not), and ``reference/`` imports nothing of the
program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "e4s_tpu"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.partition(".")[0]


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & (FORBIDDEN | {"e4s_tpu_torch"}), f


def test_no_benchmark_source_imports_jax():
    for f in sorted(BENCH.rglob("*.py")):
        assert not set(_imports(f)) & FORBIDDEN, f


@pytest.mark.parametrize("cell", ["swap.single", "reenact.batch"])
def test_a_run_loads_no_forbidden_module(cell, tmp_path):
    """A whole tiny run of a cell of each configuration on the CPU, in a
    fresh process, then ``sys.modules`` by top-level name."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from pathlib import Path
from benchmark.tests.tiny import make_tree, narrow_sr
from benchmark.harness import cell
root = Path({str(tmp_path)!r})
bench = make_tree(root)
for trace in (False, True):
    with narrow_sr():
        res, _, _ = cell.run({cell!r}, 5, 0.5, trace, time.perf_counter(), device="cpu",
                             root=root, bench_dir=bench)
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "e4s_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_forbidden_check_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell

    monkeypatch.setitem(sys.modules, "e4s_tpu_torch_fake", sys)
    assert "e4s_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "e4s_tpu.models", sys)
    assert "e4s_tpu" in cell.forbidden_modules()

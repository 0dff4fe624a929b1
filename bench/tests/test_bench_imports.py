"""The benchmark's process never holds the JAX package or JAX, the
reference holds nothing of the program, and nothing under ``bench/``
reads the JAX package's benchmarks."""

import ast
import re
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOAD_ALL = r'''
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from pathlib import Path
from bench.harness import runner, check, flops, model, spec, trace
from repro_torch.launch import fig6
from repro_torch.serving import engine
import bench.limits
for folder in ("traffic", "families", "reference", "metrics"):
    for p in sorted((spec.BENCH_DIR / folder).glob("*.py")):
        if p.stem != "__init__":
            spec.module(folder, p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''

LOAD_REFERENCE = r'''
import json, sys
sys.path[:0] = [{root!r}]
import bench.reference.decoder
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), src=str(ROOT / "src"))], capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax_and_no_repro():
    names = modules_after(LOAD_ALL)
    assert "repro_torch" in names and "torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = modules_after(LOAD_REFERENCE)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"repro_torch"})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_under_bench_names_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path) if m}
        assert not tops & FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in tops, path
        text = path.read_text()
        if path.name != "test_bench_imports.py":
            assert "BENCH_core" not in text and "benchmarks/" not in text, path
            assert not re.search(r"BENCH_[a-z]+\.json", text), path

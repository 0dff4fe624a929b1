"""``bench/run.py`` as the check runs it: with no CUDA card, or in a tree
that holds only ``BENCHMARK.json`` and ``bench/``, it exits non-zero and
prints no result."""

import shutil
import subprocess
import sys

import pytest

from conftest import CELL, ROOT

ARGS = ["--workload", CELL, "--seed", str(2 ** 31 + 3),
        "--seconds", "1", "--trace", "0"]


def run_in(cwd):
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = run_in(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_bench_alone_no_result(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_in(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

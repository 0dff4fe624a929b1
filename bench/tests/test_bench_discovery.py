"""A configuration, a model family, a traffic mix of a new kind, a cell
and a per-layer metric are added by adding files and ``BENCHMARK.json``
entries: the harness of a copy of the tree finds them and runs the new
cell, with no edit to any file it had."""

import json
import shutil
import subprocess
import sys

from bench.harness import spec
from conftest import ROOT, SERVE_MIX, TINY_DENSE

# a new kind: the serve_waves driver with a window of one wave
NEW_KIND = '''"""A test's kind: one wave a window."""
from bench.harness import spec

_base = spec.kind("serve_waves")
readings = _base.readings


def run(ctx):
    ctx.seconds = 0.0
    return _base.run(ctx)
'''

# a new family: the decoder's program side and reference under another name
NEW_FAMILY = '''"""A test's family: the decoder's layout and program side."""
from bench.harness import spec

_base = spec.family("decoder")
leaves, port_model = _base.leaves, _base.port_model
'''
NEW_REFERENCE = '''"""A test's reference: the decoder's."""
from bench.reference.decoder import exact_float32, logits  # noqa: F401
'''

NEW_METRIC = '''"""Kernels: device kernels a probe step (a test's metric)."""


def read(run):
    probe = run.out.get("probe")
    return probe["steps"] if probe else None
'''

RUN_NEW_CELL = r'''
import json, sys, time
sys.path[:0] = [".", {src!r}]
import torch
torch.set_num_threads(1)
from bench.harness import runner
res = runner.run_cell("tiny-dense.chat", 4, 0.0, True, time.perf_counter(),
                      device="cpu", emit=lambda line: None)
print(json.dumps(res))
'''


def test_files_dropped_in_are_found_and_run(tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    before[root / "BENCHMARK.json"] = (root / "BENCHMARK.json").read_bytes()

    conf = {**json.loads((root / "bench/configs/mixtral-8x7b-pp2-eps1e-6.json")
                         .read_text()), **TINY_DENSE, "name": "tiny-dense",
            "family": "tiny_decoder"}
    conf.pop("num_local_experts")
    (root / "bench/configs/tiny-dense.json").write_text(json.dumps(conf))
    (root / "bench/families/tiny_decoder.py").write_text(NEW_FAMILY)
    (root / "bench/reference/tiny_decoder.py").write_text(NEW_REFERENCE)
    mix = {**json.loads((root / "bench/traffic/chat.json").read_text()),
           **SERVE_MIX, "kind": "one_wave"}
    (root / "bench/traffic/tiny-chat.json").write_text(json.dumps(mix))
    (root / "bench/traffic/one_wave.py").write_text(NEW_KIND)
    (root / "bench/cells/tiny-dense.chat.json").write_text(
        json.dumps({"limits": {"mean_gap": 0.5}}))
    (root / "bench/metrics/probe.steps.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": "a test",
                             "file": "bench/configs/tiny-dense.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-dense.chat",
                               "config": "tiny-dense", "traffic": "tiny-chat",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny-dense.chat")
    bench["per_layer"].append({"name": "probe.steps", "unit": "steps",
                               "better": "lower", "source": "host_clock",
                               "layer": "model step",
                               "moves": "serve_tokens_per_s",
                               "workloads": ["tiny-dense.chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = spec.benchmark(root)
    assert spec.config(got, "tiny-dense", root)["hidden_size"] == 64
    assert spec.traffic("tiny-chat", root / "bench")["slots"] == 2
    names = [m["name"] for m in spec.metrics(got, "tiny-dense.chat", True)]
    assert names == ["probe.steps"]
    assert [m["name"] for m in spec.metrics(got, "tiny-dense.chat", False)] \
        == ["serve_tokens_per_s", "setup_s"]

    out = subprocess.run(
        [sys.executable, "-c", RUN_NEW_CELL.format(src=str(ROOT / "src"))],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"] == {"probe.steps": {"value": 2.0,
                                              "unit": "steps"}}
    # nothing the tree had was edited but BENCHMARK.json's entries
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p

"""Shared pieces of the benchmark's tests.  They run on the CPU at tiny
sizes; a test marked ``chip`` needs a CUDA card and skips without one
(decided in the ``cuda`` fixture, never at import).  Run them from the
root of the checkout:

    python -m pytest -q bench/tests
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MOE = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
                num_local_experts=4, num_experts_per_tok=2, vocab_size=512)
TINY_DENSE = dict(hidden_size=64, intermediate_size=192,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  num_hidden_layers=2, vocab_size=512)
SERVE_MIX = dict(wave_requests=4, prompt_max=8, output_max=6, max_len=64,
                 slots=2, probe=dict(slots=2, context=8, steps=2,
                                     profiled_steps=1),
                 engine_profile=dict(skip_steps=2, steps=3))
# the cell and configuration the tests run, at tiny sizes
CELL = "mixtral-eps1e-6.chat"
CONFIG = "mixtral-8x7b-pp2-eps1e-6"
TINY = {CELL: dict(conf=TINY_MOE, mix=SERVE_MIX)}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(workload, seed=3, trace=False, overrides=None, seconds=0.0):
    """One run of ``workload`` at a tiny size on the CPU; returns the
    result line as a dict."""
    from bench.harness import runner
    over = {k: dict(v) for k, v in TINY[workload].items()}
    for k, v in (overrides or {}).items():
        over[k] = {**over.get(k, {}), **v}
    lines = []
    return runner.run_cell(workload, seed, seconds, trace,
                           time.perf_counter(), device="cpu",
                           overrides=over, emit=lines.append)


def tiny_context(workload, seed=3, overrides=None):
    from bench.harness import runner
    over = {k: dict(v) for k, v in TINY[workload].items()}
    for k, v in (overrides or {}).items():
        over[k] = {**over.get(k, {}), **v}
    return runner.build_context(workload, seed, 0.0, False,
                                time.perf_counter(), device="cpu",
                                overrides=over)

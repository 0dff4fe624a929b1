"""The control, the reference in the program's place in the precision
below the configuration's (every projection's inputs rounded to float8
e4m3 for mixtral's bf16), reads far above the sound program on every
seed, here at a size a test run holds.  The chip test reads it at the
cell's own size against its limit (the readings the limit was set from
are in PERF.md)."""

import pytest

from bench.harness import runner, spec
from conftest import CELL, tiny_context


def readings(ctx, control=True):
    return spec.kind(ctx.mix["kind"]).readings(ctx, control)


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_serving_control_reads_above_the_program(seed):
    nums = readings(tiny_context(CELL, seed))
    assert nums["control_mean_gap"] >= 3 * max(nums["mean_gap"], 0.01)


@pytest.mark.chip
def test_control_fails_the_limit_at_the_cells_size(cuda):
    lim = spec.cell(CELL)["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctx = runner.build_context(CELL, seed, 0.0, False, 0.0)
        nums = readings(ctx)
        assert nums["control_mean_gap"] > lim["mean_gap"]

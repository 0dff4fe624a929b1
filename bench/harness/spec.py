"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix.  Everything else is found by those names:

  * a configuration: the ``file`` its ``configs`` entry gives;
  * a traffic mix: ``bench/traffic/<traffic>.json``, data;
  * the mix's kind, its generator and driver: ``bench/traffic/<kind>.py``
    (``kind`` in the mix), a module with ``run(ctx)`` and
    ``readings(ctx, control)``;
  * a model family's program side: ``bench/families/<family>.py``
    (``family`` in the configuration), with ``leaves(conf)`` and
    ``port_model(conf, weights)``;
  * its plain reference: ``bench/reference/<family>.py``;
  * a cell's limits: ``bench/cells/<cell>.json``;
  * a per-layer metric's reader: ``bench/metrics/<metric>.py``, a module
    with ``read(run) -> float | None``.

Adding a cell, a configuration, a mix, a kind, a family or a metric
therefore adds files and ``BENCHMARK.json`` entries and edits nothing
here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json; known: "
                   f"{sorted(e['name'] for e in entries)}")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / _named(bench["configs"], name, "config")["file"])


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return load_json(bench_dir / "cells" / f"{name}.json")


def module(folder: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``bench/<folder>/<name>.py``, loaded once a process."""
    path = bench_dir / folder / f"{name}.py"
    key = f"bench_{folder}_" + "".join(c if c.isalnum() else "_"
                                       for c in name)
    mod = sys.modules.get(key)
    if mod is not None and mod.__file__ == str(path):
        return mod
    if not path.is_file():
        raise KeyError(f"no {folder} module {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """A mix kind's generator and driver, ``bench/traffic/<name>.py``."""
    return module("traffic", name, bench_dir)


def family(name: str, bench_dir: Path = BENCH_DIR):
    """A model family's program side, ``bench/families/<name>.py``."""
    return module("families", name, bench_dir)


def reference(name: str, bench_dir: Path = BENCH_DIR):
    """A model family's plain reference, ``bench/reference/<name>.py``."""
    return module("reference", name, bench_dir)


def applies(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether ``metric`` is reported in ``cell_name``: the cells its
    ``workloads`` key lists, or, without one, every cell (an end-to-end
    metric) or every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = _named(bench["end_to_end"], metric["moves"], "metric")
        return applies(moved, cell_name, bench)
    return True


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or its per-layer
    metrics (``trace`` true), in ``BENCHMARK.json``'s order."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if applies(m, cell_name, bench)]


def reader(name: str, bench_dir: Path = BENCH_DIR
           ) -> Callable[[object], Optional[float]]:
    """``read`` of ``bench/metrics/<name>.py``."""
    return module("metrics", name, bench_dir).read

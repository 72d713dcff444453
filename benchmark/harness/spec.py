"""What the benchmark reads from its files, by name: ``BENCHMARK.json`` at
the checkout's root, a configuration (``configs/<name>.json``), a traffic
mix (``traffic/<name>.json``), a cell's limits (``checks/<cell>.json``)
and a per-layer metric's reader (``metrics/<name>.py``, whose ``read``
takes the run's record and returns a number or None). A cell, a
configuration, a traffic mix or a metric is added by adding its files and
its entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "checks" / f"{cell_name}.json")


def metrics_of(bench: dict, cell_name: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

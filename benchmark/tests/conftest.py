"""Fixtures of the benchmark's CPU tests: a benchmark directory of its own
holding one tiny cell (the real configuration with 8 features and 8 depth
planes, 64x32 frames from 128x96 scenes, chunks of 4 frames) beside copies
of the real metric readers, and the ``cuda`` marker for tests that need a
card (they skip here; run them on the card with ``python3 -m pytest
benchmark/tests -m cuda``)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import spec  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")
    # the tiny cells' windows last seconds: a few threads a process keep a
    # chunk's frames inside them when tests run side by side
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))


def has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def write_tiny(bench_dir, entry="run_trajectory", lanes=1, kind="scannet",
               limits_of="scannet_stream", cell_name="tiny_cell"):
    """A benchmark directory with one tiny cell; returns (bench, cell)."""
    bd = spec.BENCH_DIR
    shutil.copytree(bd / "metrics", bench_dir / "metrics",
                    dirs_exist_ok=True)
    for d in ("configs", "traffic", "checks"):
        (bench_dir / d).mkdir(parents=True, exist_ok=True)
    src = "kvnet_scannet" if kind == "scannet" else "kvnet_kitti768"
    cfg = spec.config(src)
    cfg["model"].update(feature_dim=8, kv_feature_dim=8, ndepth=8)
    cfg["data"].update(orig_wh=[128, 96] if kind == "scannet" else [1242, 375],
                       img_wh=[64, 32] if kind == "scannet" else [128, 32])
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = dict(entry=entry, lanes=lanes, distinct_scenes=max(2, lanes),
              scene_frames={kind: 12 if kind == "scannet" else 22},
              warmup_frames={kind: 7 if kind == "scannet" else 17},
              chunk_t=4, step=1, check_lanes=min(2, lanes),
              trace=dict(from_step=2, steps=3))
    (bench_dir / "traffic" / "tiny.json").write_text(json.dumps(tr))
    shutil.copy(bd / "checks" / f"{limits_of}.json",
                bench_dir / "checks" / f"{cell_name}.json")
    bench = spec.benchmark()
    cell = dict(name=cell_name, config="tiny", traffic="tiny", chips=1,
                why="a tiny cell of the CPU tests")
    bench["workloads"] = [cell]
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            m["workloads"] = [cell_name]
    return bench, cell


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench, cell, bench_dir) of a tiny stream cell, its temporary
    files under the test's own directory."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bench, cell = write_tiny(tmp_path / "benchmark")
    return bench, cell, tmp_path / "benchmark"

"""The cell ``kitti768_stream``: its files parse and keep to the contract,
the ``.stream`` readers it reports read a record of KITTI's shapes at
KITTI's bounds, a tiny KITTI cell runs end to end on the CPU from new
files alone, and the control of the check fails its limits where the
program passes them."""

import json
import time

import pytest

from benchmark.harness import check, counts, drive, spec
from conftest import has_card, write_tiny
from test_bench_control import _holds, _readings

CELL = "kitti768_stream"
READERS = ("frame_period_ms", "step_mfu", "step_call_host_ms",
           "capture_ms_per_scene", "export_ms", "device_idle_pct",
           "sweep_fused_roofline", "resample_roofline")


def test_the_cells_files():
    b = spec.benchmark()
    cell = spec.cell(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kvnet_kitti768", "stream_drives", 1)
    cfg = spec.config(cell["config"])
    assert next(c for c in b["configs"] if c["name"] == cell["config"])[
        "file"] == "benchmark/configs/kvnet_kitti768.json"
    assert cfg["reduced"] == [] and cfg["data"]["crop_w"] is None
    assert cfg["data"]["img_wh"] == [768, 256]
    tr = spec.traffic(cell["traffic"])
    assert set(tr) == set(spec.traffic("stream_scenes"))
    assert tr["scene_frames"] == {"kitti": 274}
    assert "1708.06500" in tr["scene_frames_source"]
    # the warm-up drive reaches both keys a drive captures: the first
    # frame's and the steady frame's (5 exported frames, as ScanNet's)
    assert tr["warmup_frames"]["kitti"] - 10 - 5 >= 2
    lim = spec.limits(CELL)
    assert set(lim) == set(check.NAMES) - {"missing_frames"}
    assert all(v > 0 for v in lim.values())
    e2e = {m["name"] for m in spec.metrics_of(b, CELL, "end_to_end")}
    assert e2e == {"frames_per_s", "setup_s"}
    per_layer = {m["name"] for m in spec.metrics_of(b, CELL, "per_layer")}
    assert per_layer == {f"{k}.stream" for k in READERS}


def _record(kernels: dict) -> dict:
    """A traced run's record at KITTI's shapes: one card, 6 steps in the
    window 85 ms apart, one call begun in it, and a profiler slice holding
    ``kernels``."""
    m = spec.config("kvnet_kitti768")["model"]
    flops = counts.frame(m, (768, 256), True)
    steps = [{"device": "cuda:0", "lanes": 1, "wall": 10.0 + 0.085 * k,
              "host_ms": 1.0, "done": 10.1 + 0.085 * k, "call": 0,
              "flops": flops} for k in range(6)]
    return {"window": (10.0, 20.0), "steps": steps,
            "calls": [{"start": 12.0, "captures_ms": [300.0, 200.0]}],
            "exports": [(11.0, 40.0), (12.0, 50.0)], "model": dict(m),
            "img_wh": (768, 256), "lanes_per_step": 1, "peak": "fp32",
            "peak_flops": counts.PEAK_FLOPS["fp32"],
            "slice": {"busy_s": 0.99, "window_s": 1.0, "kernel_s": kernels,
                      "gaps": [], "ops_before": 0}}


def test_the_stream_readers_read_kitti_shapes():
    """The cell's readers work their bounds out from the record's model and
    frame size: at the 192x64 grid, 0.0346 ms of operations for B1 and
    6.3 MB of bytes for B2 (0.0019 ms), over the kernels' mean times."""
    rec = _record({"void sweep_fused_kernel<64>(...)": (0.0024, 12),
                   "predict_kernel": (0.00012, 12),
                   "conv_kernel<128, 128>": (0.5, 1656)})
    got = {k: spec.reader(f"{k}.stream")(rec) for k in READERS}
    assert got == pytest.approx({
        "frame_period_ms": 85.0,
        "step_mfu": 100 * counts.frame(rec["model"], (768, 256), True)
        / 0.085 / 67e12,
        "step_call_host_ms": 1.0,
        "capture_ms_per_scene": 500.0,
        "export_ms": 45.0,
        "device_idle_pct": 1.0,
        "sweep_fused_roofline": 100 * counts.bound_ms(
            *counts.sweep(4, 64, 64, 192, 67)[::-1])[0] / 0.2,
        "resample_roofline": 100 * 6291456 / 3.35e12 * 1e3 / 0.01})
    assert counts.bound_ms(*counts.sweep(4, 64, 64, 192, 67)[::-1])[0] == \
        pytest.approx(0.0346, abs=5e-5)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_a_tiny_kitti_cell_runs_from_new_files_alone(tmp_path, monkeypatch,
                                                      trace):
    """The tiny KITTI cell (``conftest.write_tiny``: the real configuration
    with 8 features and 8 planes, 128x32 frames from 1242x375 drives of 22
    frames) with this cell's limits and readers, through ``run_cell`` on
    the CPU; nothing under ``benchmark/`` is written."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    before = {p: p.read_bytes() for p in spec.BENCH_DIR.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    bd = tmp_path / "benchmark"
    bench, cell = write_tiny(bd, kind="kitti", limits_of=CELL,
                             cell_name="tiny_kitti")
    r = drive.run_cell(bench, cell, 2**33 + 21, 8.0, trace, time.time(),
                       device="cpu", bench_dir=bd)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"]["platform"] == "cpu"
    if trace:
        # no card: no device trace, so the period and the MFU alone
        assert {"frame_period_ms.stream", "step_mfu.stream"} <= set(
            r["metrics"])
        assert set(r["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    json.dumps(r)
    after = {p: p.read_bytes() for p in spec.BENCH_DIR.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_control_fails_the_kitti_limits_on_the_cpu(tmp_path):
    _holds(_readings(tmp_path, "cpu", "kitti"), "kitti")


@pytest.mark.cuda
def test_control_fails_the_kitti_limits_on_the_card(tmp_path):
    if not has_card():
        pytest.skip("needs a CUDA card: TF32 is the card's")
    _holds(_readings(tmp_path, "cuda", "kitti"), "kitti")

"""The benchmark is driven by its files: a configuration, a traffic mix, a
per-layer metric and a cell added as new files and a new ``workloads``
entry are found by name and run with no edit to a file that is there; and
``BENCHMARK.json`` keeps to the contract's names, units and limits."""

import json
import shutil
import time

from benchmark.harness import drive, spec
from conftest import write_tiny


def test_an_added_cell_runs_from_new_files_alone(tmp_path, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bd = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in spec.BENCH_DIR.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    # new files only: a configuration, a traffic mix, the cell's limits
    # and a per-layer metric's reader
    bench, cell = write_tiny(bd, cell_name="added_cell")
    (bd / "metrics" / "frames_seen.added.py").write_text(
        "def read(record):\n    return float(len(record['steps']))\n")
    bench["per_layer"].append({
        "name": "frames_seen.added", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "step",
        "moves": "frames_per_s", "workloads": ["added_cell"]})
    assert spec.cell(bench, "added_cell") is cell
    assert spec.config("tiny", bd)["model"]["ndepth"] == 8
    assert spec.traffic("tiny", bd)["entry"] == "run_trajectory"
    r = drive.run_cell(bench, cell, 2**31 + 23, 8.0, True, time.time(),
                       device="cpu", bench_dir=bd)
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_seen.added"]["value"] > 0
    assert "frame_period_ms.stream" in r["metrics"]
    after = {p: p.read_bytes() for p in spec.BENCH_DIR.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_benchmark_json_keeps_to_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(b)) < 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith(
        "benchmark/")
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[sec]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME_RE.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (spec.ROOT / c["file"]).is_file()
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.NAME_RE.match(w["config"]) and spec.NAME_RE.match(
            w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec.config(w["config"]), spec.traffic(w["traffic"])
        from benchmark.harness import check
        assert set(spec.limits(w["name"])) == set(check.NAMES) - {
            "missing_frames"}
        e2e = {m["name"] for m in spec.metrics_of(b, w["name"],
                                                  "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(b, w["name"], "per_layer")
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    e2e_names = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert spec.UNIT_RE.match(m["unit"]) and m["better"] in (
            "lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]) and m["moves"] in e2e_names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(spec.reader(m["name"]))
        layers.setdefault(m["layer"], m["layer"])
        for w in m.get("workloads", []):
            spec.cell(b, w)
            assert m["moves"] in {x["name"] for x in spec.metrics_of(
                b, w, "end_to_end")}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"

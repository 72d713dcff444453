"""The port's tracing (``utils/profiler.py``): host spans in the loop, the
graph and the exporter, device stamps at the step's module boundaries,
and the Chrome-trace writer.

The loop runs on the CPU at ``tests/test_torch_loop.py``'s size (a
10-frame ``write_scannet_scene`` read at 96x64, D=8, feature_dim 16), with
a seeded random ``KVNet``, graphed (``chunk_t=4``): on CPU tensors a
``StepGraph`` runs the step on its static buffers, and the stamps are the
plain twin's (the host's clock).

- Off, a span is the shared no-op and nothing is stamped; the loop's
  files are the same bytes with tracing on and off.
- On, two ``run_trajectory`` calls: one ``scene`` span per call with its
  own id, every span inside its parent and carrying its scene's id
  (export threads too), each frame's ``decode.wait`` and ``step.call``
  around ``graph.copy_in`` and ``graph.replay``, or, on a key's first
  call, ``graph.capture`` around ``graph.warmup`` and ``graph.record``;
  ``scene.drain`` last.
- Two lockstep lanes carry their ``lane`` and ``device``.
- The stamps come in module order and tile the step, which lies inside
  the host span that ran it, its ends within 1 ms of the span's on a
  typical step.
- A full span buffer and a full ring count their drops.
- A span under torch.profiler encloses the profiler's event of the op in
  it: one clock.
- The Chrome trace loads with every span; ``test_kvnet --trace_out``
  writes one.

This file imports no JAX: the test marked ``cuda`` (a graphed step on the
card stamps each replay anew, a key captured with tracing off stamps
nothing) runs on the machine with the card (``python -m pytest
--noconftest -m cuda tests/test_torch_spans.py``); here it skips.
"""

import json
import os

import numpy as np
import pytest
import torch

from neuralrgbd_tpu_torch.cli.test_kvnet import main as port_cli
from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import (synthetic_batch,
                                                 write_scannet_scene)
from neuralrgbd_tpu_torch.infer import loop
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.cuda import stamp as stamp_mod
from neuralrgbd_tpu_torch.utils import profiler

SMALL = dict(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
             d_max=4.0)
CFG = ModelConfig(**SMALL)
IMG_WH = (96, 64)
FRAMES = [2, 3, 4, 5, 6]          # the reference frames of a 10-frame scene
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread for this module's tests (the suite runs files
    in parallel worker processes), the caller's count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return KVNet(CFG, device="cpu", seed=0, single_refine=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    write_scannet_scene(root, n_frames=10)
    return root


def trajectory(root: str):
    return make_trajectory(0, 5, root, img_size_wh=IMG_WH,
                           d_candi=CFG.d_candi)


def traced(fn, devices=()):
    """``fn()`` with tracing on: (its result, ``take()``'s record)."""
    profiler.enable(devices)
    try:
        out = fn()
    finally:
        record = profiler.take()
    return out, record


def same_bytes(a: str, b: str) -> bool:
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        open(os.path.join(a, n), "rb").read()
        == open(os.path.join(b, n), "rb").read() for n in names)


@pytest.fixture(scope="module")
def run(model, scene, tmp_path_factory):
    """Two traced ``run_trajectory`` calls on the scene, graphed (the
    CPU's ring made and anchored when tracing turns on)."""
    base = tmp_path_factory.mktemp("traced")
    dirs = [str(base / f"call{k}") for k in range(2)]
    counts, record = traced(lambda: [
        loop.run_trajectory(model, CFG, trajectory(scene), d,
                            verbose=False, chunk_t=4) for d in dirs], [CPU])
    assert counts == [len(FRAMES)] * 2
    return dirs, record


def by_id(record) -> dict:
    return {s["id"]: s for s in record["spans"]}


def children(record, parent: dict, name=None) -> list:
    return sorted((s for s in record["spans"] if s["parent"] == parent["id"]
                   and name in (None, s["name"])),
                  key=lambda s: s["start_ns"])


def test_tracing_off_records_nothing(model, scene, run, tmp_path):
    assert not profiler.enabled() and profiler.current() is None
    assert profiler.span("a", frame=1) is profiler.span("b") is profiler.NULL
    assert profiler.stamped(CPU) is profiler.NULL
    with pytest.raises(RuntimeError, match="tracing is off"):
        profiler.take()
    ring = profiler._rings[CPU][0]      # made by the traced run
    before = int(ring.count[0])
    off = str(tmp_path / "off")
    loop.run_trajectory(model, CFG, trajectory(scene), off, verbose=False,
                        chunk_t=4)
    assert int(ring.count[0]) == before
    assert same_bytes(run[0][0], off) and same_bytes(run[0][1], off)


def test_spans_nest_inside_their_scene(run):
    _, record = run
    spans, ids = record["spans"], by_id(run[1])
    assert record["dropped"] == 0
    scenes = [s for s in spans if s["name"] == "scene"]
    assert len(scenes) == 2 and len({s["id"] for s in scenes}) == 2
    assert all(s["parent"] == 0 and s["scene"] == s["id"] for s in scenes)
    for s in spans:
        if s["parent"]:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"], (s["name"], p["name"])
            assert s["scene"] == p["scene"]
    for sc in scenes:
        main = [s for s in children(record, sc)
                if s["thread"] == sc["thread"]]
        assert main[0]["name"] == "scene.setup"
        assert main[-1]["name"] == "scene.drain"
        calls = [s for s in main if s["name"] == "step.call"]
        assert [s["frame"] for s in calls] == FRAMES
        assert all(s["device"] == "cpu" for s in calls)
        waited = {s["frame"] for s in main if s["name"] == "decode.wait"}
        assert set(FRAMES) <= waited
        # the first frame's key (no carry) and the steady key are
        # captured; every later call replays
        for k, call in enumerate(calls):
            inner = [s["name"] for s in children(record, call)]
            if k < 2:
                assert inner == ["graph.capture"]
                cap = children(record, call)[0]
                assert cap["key"] == str((k == 1,))
                assert [s["name"] for s in children(record, cap)] == [
                    "graph.warmup", "graph.record"]
            else:
                assert inner == ["graph.copy_in", "graph.replay"]


def test_export_thread_spans_carry_their_scene(run):
    _, record = run
    main = {s["thread"] for s in record["spans"] if s["name"] == "scene"}
    for sc in (s for s in record["spans"] if s["name"] == "scene"):
        chunks = children(record, sc, "export.chunk")
        assert len(chunks) == 2          # 5 frames in chunks of 4
        frames = [f for c in chunks for f in children(record, c)]
        assert [f["frame"] for f in frames] == list(range(len(FRAMES)))
        for s in chunks + frames:
            assert s["scene"] == sc["id"] and s["thread"] not in main
            assert s["device"] == "cpu"
        assert all(f["name"] == "export.frame" and f["lane"] == 0
                   for f in frames)


def test_lockstep_lanes_carry_lane_and_device(model, scene, tmp_path):
    dirs = [str(tmp_path / f"lane{i}") for i in range(2)]
    counts, record = traced(lambda: loop.run_trajectories_parallel(
        model, CFG, [trajectory(scene)] * 2, dirs, verbose=False,
        chunk_t=4))
    assert counts == [len(FRAMES)] * 2
    for name in ("decode.wait", "export.frame"):
        spans = [s for s in record["spans"] if s["name"] == name]
        assert {s["lane"] for s in spans} == {0, 1}
        assert {s["device"] for s in spans} == {"cpu"}
    # one step a lockstep frame for both lanes: a stamp set per lane
    steps = profiler.stamp_spans(record["stamps"])
    lanes = {(s["step"], s["lane"]) for s in steps if s["name"] == "rnet"}
    assert lanes == {(k, lane) for k in range(len(FRAMES))
                     for lane in (0, 1)}


def test_cpu_stamps_tile_the_step(run):
    _, record = run
    assert record["stamps_dropped"] == {"cpu": 0}
    assert set(record["clock"]) == {"cpu"}
    spans = profiler.stamp_spans(record["stamps"])
    steps = [s for s in spans if s["name"] == "step"]
    assert len(steps) == 2 * len(FRAMES)
    # the host spans that ran the step: a key's warm-up, or a replay
    hosts = sorted((s for s in record["spans"]
                    if s["name"] in ("graph.warmup", "graph.replay")),
                   key=lambda s: s["start_ns"])
    assert len(hosts) == len(steps)
    gaps = []
    for k, (step, host) in enumerate(zip(steps, hosts)):
        modules = [s for s in spans if s["step"] == k and s is not step
                   and s["name"] != "step"]
        want = ["dnet", "sweep", "knet", "rnet", "predict"]
        if k % len(FRAMES) == 0:         # a scene's first frame: no carry
            want.remove("knet")
        assert [m["name"] for m in modules] == want
        assert modules[0]["start"] == step["start"]
        assert modules[-1]["end"] == step["end"]
        assert all(a["end"] == b["start"] for a, b in zip(modules,
                                                          modules[1:]))
        assert sum(m["end"] - m["start"] for m in modules) \
            == step["end"] - step["start"]
        gaps.append((step["start"] - host["start_ns"],
                     host["end_ns"] - step["end"]))
    # the step lies inside the host span that ran it, within 1 ms of its
    # ends on a typical step (a busy host may preempt any one of them)
    assert min(min(g) for g in gaps) >= 0
    assert all(np.median(g) < 1_000_000 for g in zip(*gaps))


def test_full_buffers_count_their_drops(monkeypatch):
    ring = stamp_mod.Ring(CPU, 4)
    for tag in range(6):
        stamp_mod.stamp(ring, tag)
    rows, dropped = ring.read()
    assert rows[:, 0].tolist() == [0, 1, 2, 3] and dropped == 2
    assert np.all(np.diff(rows[:, 1]) >= 0)
    monkeypatch.setattr(profiler, "SPAN_CAPACITY", 3)
    profiler.enable()
    try:
        for k in range(5):
            with profiler.span("s", frame=k):
                pass
    finally:
        record = profiler.take()
    assert [s["frame"] for s in record["spans"]] == [0, 1, 2]
    assert record["dropped"] == 2


def test_span_encloses_the_profilers_event():
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    profiler.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiler.span("matmul_region"):
                a @ b
    finally:
        record = profiler.take()
    (s,) = record["spans"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    mm = events["aten::mm"]
    assert s["start_ns"] <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= s["end_ns"]
    assert "matmul_region" in events      # a record_function range too


def test_chrome_trace_holds_every_span(run, tmp_path):
    _, record = run
    path = str(tmp_path / "trace.json")
    profiler.write_chrome_trace(path, record)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"
             and e["pid"] < profiler.DEVICE_PID]
    assert sorted(e["args"]["id"] for e in spans) == sorted(by_id(record))
    device = [e for e in events if e["ph"] == "X"
              and e["pid"] >= profiler.DEVICE_PID]
    assert len(device) == len(profiler.stamp_spans(record["stamps"]))
    assert all(e["dur"] >= 0 for e in spans + device)


def test_test_kvnet_writes_its_trace(scene, tmp_path):
    path = str(tmp_path / "t.json")
    port_cli(["--dataset", "scannet", "--dataset_path", scene,
              "--ndepth", "8", "--feature_dim", "16", "--d_min", "0.5",
              "--d_max", "4.0", "--img_width", "96", "--img_height", "64",
              "--chunk_t", "4", "--device", "cpu",
              "--res_dir", str(tmp_path / "out"), "--trace_out", path])
    assert not profiler.enabled()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"scene", "step.call", "export.frame", "dnet", "predict"} <= names


@pytest.mark.cuda
def test_graphed_step_stamps_each_replay():
    """On the card: a key captured with tracing off holds no stamp, and
    replays without writing one; with tracing on, the warm-up and each
    replay write one stamp set, in module order, that tiles the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    model = KVNet(CFG, device=dev, seed=0, single_refine=True)
    b, _ = synthetic_batch(CFG, 1, img_hw=IMG_WH[::-1])
    batch = {k: torch.from_numpy(b[k]).to(dev)
             for k in ("ref", "srcs", "poses", "K", "pose_next")}
    h, w = IMG_WH[1] // 4, IMG_WH[0] // 4
    bvp = torch.log_softmax(torch.randn(1, CFG.ndepth, h, w, device=dev), 1)
    step = make_infer_step(CFG, graph=True)
    for _ in range(3):                           # captured with tracing off
        step(model, batch, bvp, [True])
    launches = stamp_mod.launches
    n = 4
    profiler.enable(devices=[dev])
    try:
        outs = [step(model, batch, bvp, [True]).depth.clone()
                for _ in range(n)]
    finally:
        record = profiler.take()
    # a stamp set (6) at the warm-up and at each of 3 replays; 2 anchors
    anchors = 2 * profiler.ANCHOR_TRIES
    assert stamp_mod.launches - launches == 6 * n + anchors
    spans = profiler.stamp_spans(record["stamps"])
    steps = [s for s in spans if s["name"] == "step"]
    assert len(steps) == n and record["stamps_dropped"] == {str(dev): 0}
    for k, st in enumerate(steps):
        modules = [s for s in spans if s["step"] == k and s["name"] != "step"]
        assert [m["name"] for m in modules] == [
            "dnet", "sweep", "knet", "rnet", "predict"]
        total = sum(m["end"] - m["start"] for m in modules)
        assert abs(total - (st["end"] - st["start"])) \
            <= 0.02 * (st["end"] - st["start"])
        assert all(m["end"] >= m["start"] for m in modules)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ring = profiler._rings[dev][0]
    before, launches = int(ring.count[0]), stamp_mod.launches
    step(model, batch, bvp, [True])              # the untraced key again
    torch.cuda.synchronize(dev)
    assert int(ring.count[0]) == before and stamp_mod.launches == launches
    print(f"clock: {record['clock']}; step ns: "
          f"{[s['end'] - s['start'] for s in steps]}")

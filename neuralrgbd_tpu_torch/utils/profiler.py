"""Tracing: spans on the host, stamps on the device, and torch.profiler
traces (counterpart of ``neuralrgbd_tpu/utils/profiler.py``).

Tracing is off by default. ``enable()`` turns it on; ``take()`` turns it
off and returns what was recorded; ``write_chrome_trace`` writes that as a
Chrome trace, which Perfetto opens beside a ``trace()`` file.

- ``span(name, frame=, lane=, device=, key=, parent=)`` is a context.
  Off, it is the shared no-op ``NULL``: one test of a module flag, no
  allocation, no ``record_function``. On, it records the name, its start
  and end on the host's wall clock (``time.time_ns()``, the clock of
  torch.profiler's events, so a span and a device trace of the same run
  line up), its own id, its parent's id (the span open on the same thread,
  or ``parent``, a span of another thread taken with ``current()``), the
  thread, its request id ``scene`` (the id of the root of its parents:
  every span of one ``infer.loop`` call, export threads included, carries
  the id of that call's ``scene`` span) and the attributes given. While a
  torch.profiler runs, a span is also a ``record_function`` range. Spans
  are kept in memory, at most ``SPAN_CAPACITY``; past that they are
  counted as dropped.
- ``stamped(device)`` around the step, and ``mark(boundary)`` at its
  module boundaries, append the device's own time to a ring on the device
  (``ops.cuda.stamp``; on the CPU the host's clock): a stamp at the step's
  start, then, per lane, after the D-Net features (``DNET``), after the
  sweep (``SWEEP``), after the K-Net fusion (``KNET``, only with a valid
  carry), after the R-Net with depth and confidence (``RNET``), and one at
  the end, after the prediction (``PREDICT``). Under a CUDA graph's capture
  the stamps become nodes of the graph, so each replay stamps anew; a key
  of ``infer.graph.StepGraph`` holds ``enabled()``, so a key captured with
  tracing off has no stamp and one captured with it on is used only while
  it is on. ``mark`` does nothing outside ``stamped`` (the model's forward
  outside the inference step: training, the LBA).
- The stamps are placed on the host's wall clock by two anchors per device
  (a synchronize, a stamp, the host's clock), one when the device's first
  stamp is taken (or at ``enable(devices)``) and one at ``take()``, which
  reads each ring once. ``take()["clock"]`` gives each device's offsets
  and their drift.
- ``trace(log_dir)``: a torch.profiler trace of a block.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch

from neuralrgbd_tpu_torch.ops.cuda import stamp as stamp_mod

# a stamp's tag: its boundary, plus 16 x its lane
STEP, DNET, SWEEP, KNET, RNET, PREDICT, ANCHOR = range(7)
BOUNDARIES = ("step", "dnet", "sweep", "knet", "rnet", "predict", "anchor")
SPAN_CAPACITY = 1 << 20
RING_SLOTS = 1 << 18          # 4 MiB of device memory per device
ANCHOR_TRIES = 4              # an anchor keeps the tightest of its tries
ANCHOR_SLOTS = 4 * ANCHOR_TRIES
DEVICE_PID = 1 << 22          # Chrome-trace pid of the first device's track


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the body, host ops and (where
    the process sees a card) CUDA kernels, written to ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` when the body ends: a Chrome trace
    that chrome://tracing, Perfetto and TensorBoard's PyTorch profiler
    plugin open (writing it needs no ``tensorboard`` package). Yields the
    profiler, for its ``key_averages()`` tables. With tracing on, each
    ``span`` in the body is a range of its own in the trace."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()
_tracer = None        # the _Tracer while tracing is on
# per device (ring of the step's stamps, ring of the clock's anchors), kept
# for the process: a graph captured with tracing on writes into its ring
_rings: dict = {}


class _Tracer:
    def __init__(self):
        self.capacity = SPAN_CAPACITY
        self.spans: list = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.threads: dict = {}       # native thread id -> name
        self.devices: list = []       # the devices with a ring in use
        self.anchors: dict = {}       # device -> [(host ns, +- ns)], a try

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def add(self, rec: tuple) -> None:
        with self.lock:
            if len(self.spans) < self.capacity:
                self.spans.append(rec)
            else:
                self.dropped += 1

    def start(self, device: torch.device) -> None:
        """The device's rings emptied and its first anchor taken."""
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the first stamp on {device} came under a CUDA graph's "
                f"capture: run the step eagerly first, or enable(devices)")
        if device not in _rings:
            _rings[device] = (stamp_mod.Ring(device, RING_SLOTS),
                              stamp_mod.Ring(device, ANCHOR_SLOTS))
        if device.type == "cuda":
            stamp_mod.load()
        _sync(device)
        for ring in _rings[device]:
            ring.count.zero_()
        self.devices.append(device)
        self.anchor(device)

    def anchor(self, device: torch.device) -> None:
        """``ANCHOR_TRIES`` stamps, each alone on the device, between two
        readings of the host's clock."""
        for _ in range(ANCHOR_TRIES):
            _sync(device)
            h0 = time.time_ns()
            stamp_mod.stamp(_rings[device][1], ANCHOR)
            _sync(device)
            h1 = time.time_ns()
            self.anchors.setdefault(device, []).append(((h0 + h1) // 2,
                                                        (h1 - h0) // 2))


def _device(device) -> torch.device:
    """``device`` with its index (a card's current one where none is
    given): the key of its rings."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    __slots__ = ("tracer", "name", "attrs", "given", "id", "parent",
                 "scene", "start", "range")

    def __init__(self, tracer, name, attrs, parent):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.given = parent
        self.range = None

    def __enter__(self):
        stack = self.tracer.stack()
        parent = self.given if self.given is not None else (
            stack[-1] if stack else None)
        self.id = next(self.tracer.ids)
        self.parent = parent.id if parent is not None else 0
        self.scene = parent.scene if parent is not None else self.id
        stack.append(self)
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.tracer.stack().pop()
        tid = threading.get_native_id()
        if tid not in self.tracer.threads:
            self.tracer.threads[tid] = threading.current_thread().name
        self.tracer.add((self.name, self.start, end, self.id, self.parent,
                         tid, self.scene, self.attrs))
        return False


def span(name: str, *, frame=None, lane=None, device=None, key=None,
         parent=None):
    """A span of ``name`` around the body (module docstring); ``NULL``
    while tracing is off."""
    if _tracer is None:
        return NULL
    return _Span(_tracer, name, (frame, lane, device, key), parent)


def current():
    """The span open on this thread, to pass as another thread's
    ``parent``; None if there is none or tracing is off."""
    if _tracer is None:
        return None
    stack = _tracer.stack()
    return stack[-1] if stack else None


def enabled() -> bool:
    return _tracer is not None


class _Stamped:
    def __init__(self, tracer, device):
        self.tracer, self.device = tracer, _device(device)
        self.lane = 0

    def __enter__(self):
        if self.device not in self.tracer.devices:
            self.tracer.start(self.device)
        self.ring = _rings[self.device][0]
        self.tracer.local.step = self
        stamp_mod.stamp(self.ring, STEP)
        return self

    def mark(self, boundary: int) -> None:
        stamp_mod.stamp(self.ring, boundary + 16 * self.lane)
        if boundary == RNET:
            self.lane += 1

    def __exit__(self, exc_type, *exc):
        self.tracer.local.step = None
        if exc_type is None:
            stamp_mod.stamp(self.ring, PREDICT)
        return False


def stamped(device):
    """Stamp the start of the step on ``device`` and, when the body ends,
    its end; ``mark`` stamps its boundaries in between. ``NULL`` while
    tracing is off."""
    if _tracer is None:
        return NULL
    return _Stamped(_tracer, device)


def mark(boundary: int) -> None:
    """Stamp a module boundary of the step open on this thread (``DNET``,
    ``SWEEP``, ``KNET``, ``RNET``; ``RNET`` ends a lane)."""
    if _tracer is None:
        return
    step = getattr(_tracer.local, "step", None)
    if step is not None:
        step.mark(boundary)


def enable(devices=()) -> None:
    """Turn tracing on. ``devices``: take their first anchors now (a
    device's first stamp takes it otherwise)."""
    global _tracer
    if _tracer is not None:
        raise RuntimeError("tracing is on already")
    tracer = _Tracer()
    for dev in devices:
        tracer.start(_device(dev))
    _tracer = tracer


def take() -> dict:
    """Turn tracing off and return what it recorded:

    - ``spans``: [{"name", "start_ns", "end_ns", "id", "parent" (0 for a
      root), "thread", "scene", and those of "frame", "lane", "device",
      "key" that were given}], in the order they ended;
    - ``dropped``: the spans past ``SPAN_CAPACITY``;
    - ``stamps``: [{"device", "lane", "boundary" (``BOUNDARIES``), "ns"}]
      on the host's wall clock, per device in the order they ran;
    - ``stamps_dropped``: {device: the stamps past the ring};
    - ``clock``: {device: {"offset_ns": [host - device at the first
      anchor and at the last], "drift_ns": last - first, "anchor_ns": the
      wider anchor's +-}};
    - ``threads``: {thread id: its name}."""
    global _tracer
    tracer, _tracer = _tracer, None
    if tracer is None:
        raise RuntimeError("tracing is off")
    stamps, dropped, clock = [], {}, {}
    for dev in tracer.devices:
        tracer.anchor(dev)
        rows, dropped[str(dev)] = _rings[dev][0].read()
        tries = [(w, int(d), h) for d, (h, w) in zip(
            _rings[dev][1].read()[0][:, 1], tracer.anchors[dev])]
        # the tightest try of the first anchor and of the last
        best = [min(tries[:ANCHOR_TRIES]), min(tries[-ANCHOR_TRIES:])]
        pairs = [(d, h) for _, d, h in best]
        offsets = [h - d for d, h in pairs]
        clock[str(dev)] = {"offset_ns": offsets,
                           "drift_ns": offsets[-1] - offsets[0],
                           "anchor_ns": max(w for w, _, _ in best)}
        # the plain twin stamps the host's clock itself
        wall = (rows[:, 1] if dev.type == "cpu"
                else _wall_ns(rows[:, 1], pairs))
        stamps += [{"device": str(dev), "lane": int(tag) >> 4,
                    "boundary": BOUNDARIES[int(tag) & 15], "ns": int(ns)}
                   for tag, ns in zip(rows[:, 0], wall)]
    spans = []
    for name, start, end, sid, parent, tid, scene, attrs in tracer.spans:
        s = {"name": name, "start_ns": start, "end_ns": end, "id": sid,
             "parent": parent, "thread": tid, "scene": scene}
        for k, v in zip(("frame", "lane", "device", "key"), attrs):
            if v is not None:
                s[k] = v if k in ("frame", "lane") else str(v)
        spans.append(s)
    return {"spans": spans, "dropped": tracer.dropped, "stamps": stamps,
            "stamps_dropped": dropped, "clock": clock,
            "threads": dict(tracer.threads)}


def _wall_ns(ns: np.ndarray, anchors: list) -> np.ndarray:
    """Device ns on the host's wall clock by anchors ``[(device ns, host
    ns), ...]``: the first anchor's offset, and the drift to the last
    spread linearly between them."""
    (d0, h0), (d1, h1) = anchors[0], anchors[-1]
    off0, off1 = h0 - d0, h1 - d1
    if d1 == d0:
        return ns + off0
    return ns + off0 + np.round(
        (ns - d0) * ((off1 - off0) / (d1 - d0))).astype(np.int64)


def stamp_spans(stamps: list) -> list:
    """The device's spans of each stamped step, from ``take()``'s stamps:
    per device and step a "step" span, from its start stamp to its end, and
    the modules that tile it, each from the stamp before to its own:
    "dnet", "sweep", "knet" (with a valid carry) and "rnet" per lane, then
    "predict". A step whose end is missing (a full ring) is left out.
    Each: {"name", "device", "lane" (None for "step" and "predict"),
    "step" (the device's count of steps before it), "start", "end"}."""
    out, steps, done = [], {}, {}
    for s in stamps:
        dev, name = s["device"], s["boundary"]
        if name == "step":
            steps[dev] = (s["ns"], [])
            continue
        if dev not in steps:
            continue
        first, modules = steps[dev]
        modules.append({"name": name, "device": dev,
                        "lane": None if name == "predict" else s["lane"],
                        "start": modules[-1]["end"] if modules else first,
                        "end": s["ns"]})
        if name == "predict":
            k = done[dev] = done.get(dev, -1) + 1
            out.append({"name": "step", "device": dev, "lane": None,
                        "step": k, "start": first, "end": s["ns"]})
            out += [dict(m, step=k) for m in modules]
            del steps[dev]
    return out


def write_chrome_trace(path: str, record: dict) -> None:
    """``take()``'s record as a Chrome trace (``ph: "X"`` events in us of
    the wall clock): the spans on this process's threads, with their ids
    and attributes as ``args``, and each device's ``stamp_spans`` on a
    track of its own."""
    pid = os.getpid()
    events = [{"ph": "M", "name": "process_name", "pid": pid,
               "args": {"name": "host spans"}}]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}}
               for tid, name in record["threads"].items()]
    for s in record["spans"]:
        events.append({
            "name": s["name"], "ph": "X", "pid": pid, "tid": s["thread"],
            "ts": s["start_ns"] / 1e3, "dur": (s["end_ns"] - s["start_ns"])
            / 1e3, "args": {k: v for k, v in s.items() if k not in (
                "name", "start_ns", "end_ns", "thread")}})
    tracks = {}
    for s in stamp_spans(record["stamps"]):
        if s["device"] not in tracks:
            tracks[s["device"]] = DEVICE_PID + len(tracks)
            events.append({"ph": "M", "name": "process_name",
                           "pid": tracks[s["device"]],
                           "args": {"name": f"{s['device']} stamps"}})
        events.append({
            "name": s["name"], "ph": "X", "pid": tracks[s["device"]],
            "tid": 0, "ts": s["start"] / 1e3,
            "dur": (s["end"] - s["start"]) / 1e3,
            "args": {"step": s["step"], "lane": s["lane"]}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {k: record[k] for k in (
                       "dropped", "stamps_dropped", "clock")}}, f)

"""What a traced run records around the program, from the benchmark's side:

- ``StepProbe`` (after ``chip_smoke.StepProbe``) wraps ``make_infer_step``
  where the loop calls it: each step call's device, lanes and carry
  validity, host start and host ms, and a CUDA event recorded on the
  device's stream after it. An anchor event per device, recorded after a
  synchronize at a known wall time, turns each event into the wall-clock
  time at which the card finished that step;
- ``ThreadTimes`` (``chip_smoke.ThreadTimes``) times each call of a module
  function from any thread: here the loop's ``export_frame``;
- ``ProfileSlice`` runs ``torch.profiler`` (device activities only) over
  a few step calls of one call made after the window, started a step
  early with no synchronize and ended by one, and reduces its events to
  busy time, kernel time by name and the longest idle gaps.

Nothing here runs in an untraced run.
"""

from __future__ import annotations

import time
from typing import NamedTuple


class Call(NamedTuple):
    device: object           # torch.device of the step's lanes
    valid: tuple             # the lanes' carry validity
    wall: float              # host wall clock at the call
    host_ms: float
    event: object            # torch.cuda.Event after the call, or None
    call: int                # the harness's call (scene or lockstep batch)


class StepProbe:
    def __init__(self, module, slice_=None):
        self.module, self.make = module, module.make_infer_step
        self.calls: list = []
        self.anchors: dict = {}  # device -> (event, wall time)
        self.current = -1        # the harness's call in progress
        self.slice = slice_

    def anchor(self, devices) -> None:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
            self.anchors[dev] = (ev, time.time())

    def __enter__(self):
        import torch

        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def timed(model, batch, bv_predict, bv_valid, *rest):
                dev = bv_predict.device
                if self.slice is not None:
                    self.slice.before_step(self, dev)
                wall, t = time.time(), time.perf_counter()
                out = step(model, batch, bv_predict, bv_valid, *rest)
                host = 1e3 * (time.perf_counter() - t)
                ev = None
                if dev.type == "cuda":
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(torch.cuda.current_stream(dev))
                self.calls.append(Call(dev, tuple(bool(v) for v in bv_valid),
                                       wall, host, ev, self.current))
                return out
            return timed

        self.module.make_infer_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_infer_step = self.make

    def done_wall(self, call: Call) -> float:
        """When the card finished the step (wall clock); the host's clock
        at the call on a CPU run."""
        if call.event is None:
            return call.wall + call.host_ms / 1e3
        ev, t0 = self.anchors[call.device]
        return t0 + ev.elapsed_time(call.event) / 1e3


class ThreadTimes:
    """Host ms of each call of ``module.name`` (from any thread), with the
    wall clock at its start."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn, self.calls = getattr(module, name), []

    def __enter__(self):
        def timed(*args, **kwargs):
            wall, t = time.time(), time.perf_counter()
            try:
                return self.fn(*args, **kwargs)
            finally:
                self.calls.append((wall, 1e3 * (time.perf_counter() - t)))
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class ProfileSlice:
    """The profiler over step calls [first, first + count) of the first
    device in harness call ``call`` (set by the harness: one call after
    the window).

    The profiler starts a step early (step ``first - 1``) and with no
    synchronize, so that its own start (CUPTI's set-up, and the first graph
    launch under it: a ~32 ms gap on the H100 where the slice began with
    it) falls before the slice. The slice begins at the first device
    operation that starts once the host has begun step ``first``, while
    the loop keeps the card's queue as full as it keeps it anyway; it ends
    at the last operation of step ``first + count - 1``, the devices
    synchronized after it. It holds those steps' work and the card's idle
    time between them."""

    def __init__(self, call: int, first: int, count: int, devices):
        self.call, self.first, self.count = call, first, count
        self.devices = list(devices)
        self.seen = 0
        self.prof = None
        self.events = None
        self.t_from_ns = None
        self.before = 0

    def before_step(self, probe: StepProbe, dev) -> None:
        if probe.current != self.call or dev != self.devices[0]:
            return
        from torch.profiler import ProfilerActivity, profile

        if self.seen == max(self.first - 1, 0):
            # the card's activities; a CPU run (the tests) records none
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.devices[0].type == "cuda"
                else ProfilerActivity.CPU])
            self.prof.start()
        if self.seen == self.first:
            self.t_from_ns = time.time_ns()
        elif self.seen == self.first + self.count:
            self.finish()
        self.seen += 1

    def finish(self) -> None:
        """Stop the profiler if it runs (also where the call ended first)
        and keep its device events."""
        if self.prof is None:
            return
        self._sync()
        self.prof.stop()
        events = [
            (e.name(), e.device_index(), e.start_ns(), e.duration_ns(),
             e.correlation_id())
            for e in self.prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA" and e.duration_ns() > 0]
        # the profiler's timestamps are wall-clock ns, as time.time_ns()
        kept = [e for e in events if self.t_from_ns is None
                or e[2] >= self.t_from_ns]
        self.events = kept or events
        self.before = len(events) - len(self.events)
        self.prof = None

    def _sync(self) -> None:
        import torch
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def reduce(self, host=None) -> dict:
        """{"busy_s", "window_s" (each the mean over the devices),
        "ops_before" (the device operations recorded before the slice,
        left out), "kernel_s" {name: (seconds, launches)}, "gaps" [(what
        the host did, seconds)] of the 10 longest idle gaps}, or {} if the
        slice saw no device work. ``host(t)`` names what the host was doing at
        wall-clock time t (the profiler's timestamps are wall-clock ns)."""
        if not self.events:
            return {}
        by_dev: dict = {}
        for ev in self.events:
            by_dev.setdefault(ev[1], []).append(ev)
        busy = window = 0.0
        kernel: dict = {}
        gaps = []
        for evs in by_dev.values():
            evs.sort(key=lambda e: e[2])
            end = evs[0][2]
            for name, _, start, dur, _ in evs:
                if start > end:
                    gaps.append((end, start))
                busy += (max(end, start + dur) - max(end, start)) / 1e9
                end = max(end, start + dur)
                s, n = kernel.get(name, (0.0, 0))
                kernel[name] = (s + dur / 1e9, n + 1)
            window += (end - evs[0][2]) / 1e9
        n = len(by_dev)
        gaps.sort(key=lambda g: g[0] - g[1])
        return {"busy_s": busy / n, "window_s": window / n,
                "ops_before": self.before,
                "kernel_s": kernel,
                "gaps": [(host((a + b) / 2e9) if host else "", (b - a) / 1e9)
                         for a, b in gaps[:10]]}

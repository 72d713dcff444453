"""One run of one cell: set-up, the measured window, the per-layer record
of a traced run, and the check.

Set-up: the scenes of the traffic written from the seed, the weights made
from the seed on the first card and loaded into the program's ``KVNet``,
and one warm-up call on short scenes that runs every key the cell's calls
capture (the first frame's and the steady frame's, on every card). Then the
timed calls run back to back, each one call of the program's entry
(``infer.loop.run_trajectory`` for one scene, ``run_trajectories_parallel``
for a batch of lanes over the visible cards) as ``cli/test_kvnet.py``
makes them, on scenes that the program reads from disk each time, until a
call ends after the window's close (``window.py``). The check runs after
the program's state is freed.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark.harness import check, counts, spec, window as win
from benchmark.harness import weights as weights_mod
from benchmark.harness.probes import ProfileSlice, StepProbe, ThreadTimes
from benchmark.reference.kvnet import param_spec
from benchmark.traffic import scenes

class Program:
    """The program under test at one configuration and traffic: its model
    on the first device, its trajectories, its entry."""

    def __init__(self, cfg: dict, tr: dict, weights: dict, home):
        from neuralrgbd_tpu_torch.config import ModelConfig
        from neuralrgbd_tpu_torch.infer import loop
        from neuralrgbd_tpu_torch.models.kvnet import KVNet
        from neuralrgbd_tpu_torch.parallel.mesh import lane_mesh

        self.cfg, self.tr, self.loop = cfg, tr, loop
        self.mc = ModelConfig(**cfg["model"])
        self.model = KVNet(self.mc, device=home, seed=0, single_refine=True)
        self.model.load_state_dict(weights)
        self.lanes = tr["lanes"]
        self.per_dev = (1 if tr["entry"] == "run_trajectory" else
                        self.lanes // len(lane_mesh(self.lanes, home)))

    def trajectory(self, root: str, index: int):
        data = self.cfg["data"]
        wh = tuple(data["img_wh"])
        if data["kind"] == "scannet":
            from neuralrgbd_tpu_torch.data.scannet import make_trajectory
            return make_trajectory(index, 5, root, img_size_wh=wh,
                                   d_candi=self.mc.d_candi)
        from neuralrgbd_tpu_torch.data.kitti import make_trajectory
        return make_trajectory(index, root, img_size_wh=wh,
                               crop_w=data.get("crop_w"),
                               d_candi=self.mc.d_candi)

    def call(self, trajs: list, res_dirs: list) -> list:
        """One call of the entry: every lane's exported-frame count."""
        rt, tr = self.cfg["runtime"], self.tr
        kw = dict(verbose=False, chunk_t=tr["chunk_t"], step=tr["step"],
                  cache_features=rt["cache_features"], tf32=rt["tf32"])
        if tr["entry"] == "run_trajectory":
            return [self.loop.run_trajectory(self.model, self.mc, trajs[0],
                                             res_dirs[0], **kw)]
        return self.loop.run_trajectories_parallel(
            self.model, self.mc, trajs, res_dirs, mesh=None, **kw)


def devices_for(chips: int, device=None) -> list:
    import torch
    if device is not None:
        return [torch.device(device)]
    return [torch.device("cuda", i) for i in range(chips)]


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, t_start: float, device=None,
             bench_dir=spec.BENCH_DIR) -> dict:
    """The result line's object (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with ``trace`` a ``breakdown``, and the
    compared numbers under ``checks``, last). ``device``: run on this one
    device instead of the cell's cards (the CPU tests)."""
    import torch

    cfg = spec.config(cell["config"], bench_dir)
    tr = spec.traffic(cell["traffic"], bench_dir)
    limits = spec.limits(cell["name"], bench_dir)
    devices = devices_for(cell["chips"], device)
    home, kind = devices[0], cfg["data"]["kind"]
    for d in devices:
        torch.zeros(1, device=d)          # CUDA's context on every card
    stages = {"imports and CUDA": time.time()}
    work = tempfile.mkdtemp(prefix="kvnet_bench_")
    try:
        roots = {k: os.path.join(work, k) for k in ("scenes", "warm", "out")}
        scenes.write(kind, roots["scenes"], tr["distinct_scenes"],
                     tr["scene_frames"][kind], cfg["data"]["orig_wh"], seed,
                     home)
        scenes.write(kind, roots["warm"], tr["lanes"],
                     tr["warmup_frames"][kind], cfg["data"]["orig_wh"],
                     scenes.sub_seed(seed, 1), home)
        stages["the scenes"] = time.time()
        weights = weights_mod.make(param_spec(cfg["model"]), seed, home)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        program = Program(cfg, tr, weights, home)
        stages["weights and model"] = time.time()
        lanes = tr["lanes"]
        program.call([program.trajectory(roots["warm"], i)
                      for i in range(lanes)],
                     [os.path.join(work, "warm_out", f"l{i}")
                      for i in range(lanes)])
        all_devices = sorted({*devices, *_cards(program)}, key=str)
        for d in all_devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        stages["warm-up call"] = time.time()

        rec = _Recorder(program, tr, all_devices) if trace else None
        calls = _timed_calls(program, roots, tr, seconds, rec)
        chunks = [c for k, (res_dirs, n, _, _) in enumerate(calls)
                  for c in win.chunks(k, res_dirs, n, program.per_dev,
                                      tr["chunk_t"])]
        w = win.window(chunks, seconds)
        peak = max((torch.cuda.max_memory_allocated(d) for d in all_devices
                    if d.type == "cuda"), default=0)
        stages["call 0's first chunk"] = w.open
        t = t_start
        print("set-up: " + ", ".join(
            f"{k} {v - t:.2f} s" for k, v, t in zip(
                stages, stages.values(), [t, *stages.values()])),
            file=sys.stderr)
        print(f"window: {w.frames} frames in {w.seconds:.2f} s over "
              f"{len(calls)} calls; chunks (call, s after the opening, "
              f"frames): " + " ".join(
                  f"{c.call},{c.done - w.open:.3f},{c.frames}"
                  for c in sorted(chunks, key=lambda c: c.done)),
              file=sys.stderr)
        record = rec.record(w, cfg, tr) if rec else None
        del program, rec
        gc.collect()
        if home.type == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        rng = np.random.default_rng(scenes.sub_seed(seed, 2))
        inside = [k for k, (_, _, t0, t1) in enumerate(calls)
                  if t0 < w.close and t1 > w.open]
        pairs = [(k, j) for k in inside for j in range(lanes)]
        picks = rng.choice(len(pairs), size=min(tr["check_lanes"],
                                                len(pairs)), replace=False)
        sampled = [(roots["scenes"],
                    (pairs[p][0] * lanes + pairs[p][1])
                    % tr["distinct_scenes"],
                    check.files_of(calls[pairs[p][0]][0][pairs[p][1]]))
                   for p in sorted(picks)]
        stats, missing = check.check_lanes(cfg, weights, sampled,
                                           all_devices)
        judged = check.judge(stats, missing, limits, tr["chunk_t"])
        print(f"check: {len(sampled)} lane(s), {len(stats)} frames against "
              f"the reference in {time.perf_counter() - t_check:.1f} s",
              file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    correct = (len(stats) > 0
               and all(v <= lim for v, lim in judged.values()))
    result = {"correct": correct, "attempted": w.frames,
              "failed": check.failed_frames(stats, missing, limits,
                                            tr["chunk_t"]),
              "metrics": {}, "device": _device(all_devices, peak)}
    if trace:
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            v = spec.reader(m["name"], bench_dir)(record)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        sl = record["slice"]
        if sl:
            ops = sl["kernel_s"]
            print(f"profiler slice: {sl['busy_s']:.4f} s busy of "
                  f"{sl['window_s']:.4f} s, "
                  f"{sum(n for _, n in ops.values())} device ops, "
                  f"{sum(s for s, _ in ops.values()):.4f} s summed; "
                  f"{sl['ops_before']} ops of the step before it left out",
                  file=sys.stderr)
            result["device"].update(busy_s=sl["busy_s"],
                                    window_s=sl["window_s"])
            top = sorted(ops.items(), key=lambda kv: -kv[1][0])
            result["breakdown"] = {
                "device_ops": [[n[:160], s] for n, (s, _) in top[:10]],
                "idle_gaps": [[g, s] for g, s in sl["gaps"]]}
    else:
        for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
            if m["name"] == "setup_s":
                v = w.open - t_start
            elif m["unit"] == "frames/s":
                v = w.rate
            else:
                raise ValueError(f"no measurement for {m['name']!r}")
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in judged.items()}
    return result


def _cards(program: Program) -> list:
    """The devices the program's lanes ran on (``lane_mesh``'s)."""
    if program.tr["entry"] == "run_trajectory":
        return [next(program.model.parameters()).device]
    from neuralrgbd_tpu_torch.parallel.mesh import lane_mesh
    import torch
    return [torch.device(d) for d in
            lane_mesh(program.lanes, next(program.model.parameters()).device)]


def _device(devices: list, peak: int) -> dict:
    import torch
    if devices[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices), "memory_peak_bytes": peak}


def _timed_calls(program: Program, roots: dict, tr: dict, seconds: float,
                 rec) -> list:
    """Calls until one ends after the window's close: [(res_dirs, frames
    a lane, wall start, wall end)]."""
    calls, t_open = [], None
    lanes, n = tr["lanes"], tr["distinct_scenes"]
    while True:
        k = len(calls)
        trajs = [program.trajectory(roots["scenes"], (k * lanes + j) % n)
                 for j in range(lanes)]
        res_dirs = [os.path.join(roots["out"], f"c{k:03d}_l{j}")
                    for j in range(lanes)]
        if rec:
            rec.begin(k)
        t0 = time.time()
        counts_ = program.call(trajs, res_dirs)
        t1 = time.time()
        if rec:
            rec.end(k)
        if len(set(counts_)) != 1:
            raise RuntimeError(f"lanes exported unequal frames: {counts_}")
        calls.append((res_dirs, counts_[0], t0, t1))
        if t_open is None:
            t_open = win.opening(win.chunks(
                0, res_dirs, counts_[0], program.per_dev, tr["chunk_t"]))
        if time.time() >= t_open + seconds:
            if rec is None or rec.slice.call == k:
                return calls
            # a traced run profiles one more call, after the window, so
            # that the profiler's cost falls outside it
            rec.slice.call = k + 1


class _Recorder:
    """The probes of a traced run and the record that the per-layer
    readers take."""

    def __init__(self, program: Program, tr: dict, devices: list):
        from neuralrgbd_tpu_torch.infer import graph

        self.program, self.graph = program, graph
        cards = [d for d in devices if d.type == "cuda"]
        t = tr["trace"]
        self.slice = ProfileSlice(-1, t["from_step"], t["steps"], devices)
        self.steps = StepProbe(program.loop, self.slice).__enter__()
        self.exports = ThreadTimes(program.loop, "export_frame").__enter__()
        if cards:
            self.steps.anchor(cards)
        self.calls: dict = {}

    def begin(self, k: int) -> None:
        self.steps.current = k
        self.calls[k] = [time.time(), len(self.graph.captures), None, None]

    def end(self, k: int) -> None:
        if self.slice.call == k:
            self.slice.finish()
        self.calls[k][2:] = len(self.graph.captures), time.time()

    def _host_at(self, t: float) -> str:
        """What the main thread was doing at wall-clock time ``t``."""
        if any(c.wall <= t <= c.wall + c.host_ms / 1e3
               for c in self.steps.calls):
            return "host in a step call (inputs copied in, graph launched)"
        if any(t0 <= t <= t1 for t0, _, _, t1 in self.calls.values()):
            return "host in the loop between step calls"
        return "host between the loop's calls"

    def record(self, w, cfg: dict, tr: dict) -> dict:
        self.steps.__exit__(None, None, None)
        self.exports.__exit__(None, None, None)
        m, data = cfg["model"], cfg["data"]
        W, H = data["img_wh"] if data.get("crop_w") is None else (
            data["crop_w"], data["img_wh"][1])
        return {
            "window": (w.open, w.close),
            "steps": [{"device": str(c.device), "lanes": len(c.valid),
                       "wall": c.wall, "host_ms": c.host_ms,
                       "done": self.steps.done_wall(c), "call": c.call,
                       "flops": sum(counts.frame(m, (W, H), v)
                                    for v in c.valid)}
                      for c in self.steps.calls],
            "calls": [{"start": t0, "captures_ms": [
                cap.ms for cap in self.graph.captures[a:b]]}
                for t0, a, b, _ in self.calls.values()],
            "exports": list(self.exports.calls),
            "slice": self.slice.reduce(self._host_at),
            "model": dict(m),
            "img_wh": (W, H),
            "lanes_per_step": self.program.per_dev,
            "peak": cfg["runtime"]["peak"],
            "peak_flops": counts.PEAK_FLOPS[cfg["runtime"]["peak"]],
        }

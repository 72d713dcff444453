"""Sliding-window inference over a trajectory with export (counterpart of
``neuralrgbd_tpu/infer/loop.py``'s per-frame path, built for the card).

The host loop of test_KVNet.py:171-252: for each reference frame, gate on
pose validity (reset the recurrence on a bad pose), run the step, export
depth/confidence, and advance the window. The main thread only issues
work to the card and never waits for it:

- frames decode ahead on a small thread pool (PIL releases the GIL in its
  decoders) and each is uploaded ONCE, as uint8 from pinned memory, then
  normalized on the device; windows are assembled there;
- the poses of a step go up in one pinned, non-blocking copy;
- the maps are quantized to the pgm contract on the device (``_q16``), and
  every ``chunk_t`` frames they go down in ONE non-blocking copy into
  pinned memory; an export worker waits on that copy's event and writes
  the files, with at most 3 chunks in flight per device (counted over
  all devices).

With ``cache_features`` each frame is featurized once, when it first
enters a window (``infer/step.make_frame_features``), and its maps stay on
the device, keyed by frame index, for every later window.

``run_trajectories_parallel`` runs the same loop over N trajectories in
lockstep: each lockstep frame is one step call for all lanes of a device
(a forward per lane, one prediction launch), every lane with its own
frames, feature cache, carry and output contract. As JAX's, it spreads
the lanes over the cards the process sees (``parallel.lane_mesh``), one
replica of the model on each; this thread issues every card's step in
turn, waiting for none of them.

At ``chunk_t > 1`` each step call replays a captured program, the
counterpart of JAX's chunked runners (``_run_trajectory_chunked``,
``_chunk_runner``, ``_parallel_chunk_runner``): JAX scans a chunk of
frames in one compiled program; here each step, per device, is one CUDA
graph (``infer/graph.StepGraph``), one per key (the lanes stepping, their
carry validity), captured the first time the key is seen, as is the
cached path's extractor. ``chunk_t=1`` steps eagerly, as JAX's per-frame
path does (``graph`` overrides either). The loop copies what it keeps out
of the graph's outputs before the next replay: the carry, the quantized
maps and the cached features.

``resolve_cache_features`` and its warning are copies of the JAX module's.
The JAX module's ``plan_sweep`` (the Pallas sweep's band) has no
counterpart here: the CUDA sweep takes any band.
"""

from __future__ import annotations

import math
import os
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.data import preprocess as pp
from neuralrgbd_tpu_torch.data.trajectory import (Trajectory, rel_pose,
                                                  window_indices)
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.infer.export import export_frame, save_scene_path_info
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step)
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.utils import profiler


TORCH_IMPORT_CACHE_WARNING = (
    "cache_features: params were imported from a torch checkpoint "
    "(reference-released weights); the cached-feature deviation replaces "
    "the joint-window BatchNorm statistics those weights were trained "
    "under (basic.py:245-252) with per-frame statistics, and its accuracy "
    "gate (PERF.md 'Cached-feature rollout') ran on THIS repo's trained "
    "weights only. Defaulting cache_features OFF for torch-imported "
    "params; pass --cache_features to override.")


def resolve_cache_features(requested: Optional[bool],
                           torch_imported: bool):
    """Provenance-aware default for the cached-feature deviation.

    ``requested`` is the user's tri-state flag (None = auto). For params
    imported from reference torch checkpoints the auto default is OFF (the
    trained-weights accuracy gate covered only weights trained here), and
    an explicit ON carries the warning so the deviation is never silent.
    Returns ``(resolved, warning_text_or_None)``; resolved=None keeps the
    downstream backend-based auto default (ON on TPU)."""
    if not torch_imported:
        return requested, None
    if requested is None:
        return False, TORCH_IMPORT_CACHE_WARNING
    if requested:
        return True, TORCH_IMPORT_CACHE_WARNING
    return False, None


def _q16(x: torch.Tensor) -> torch.Tensor:
    """Device-side pgm quantization, the ``(x * 1000).astype(uint16)``
    contract, clamped to [0, 65535] BEFORE the cast as JAX's ``_q16`` is, so
    the files match its bytes. CUDA has few uint16 operators: the value goes
    through int32 into int16 (the cast wraps 32768..65535 to negatives) and
    the host reads the bytes back as uint16 (``.view(np.uint16)``)."""
    return torch.clamp(x * 1000.0, 0.0, 65535.0).to(torch.int32).to(
        torch.int16)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a host sync: on the card through
    pinned memory with a non-blocking copy (the caching host allocator
    keeps the pinned block until the copy has run)."""
    # PIL's arrays are read-only; torch wants writable memory
    t = torch.from_numpy(np.require(arr, requirements=("C", "W")))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _FrameSource:
    """Decode ahead on a thread pool; upload each frame to the device once.

    ``raw(idx)`` is the decoded uint8 frame (for export), ``get(idx)`` the
    normalized frame on the device: uploaded as uint8 (a quarter of the
    fp32 bytes) and normalized there as ``(u8/255 - mean)/std`` in fp32,
    the expression and order of the JAX loop's ``_DeviceFrameCache``, each
    step an IEEE division as in numpy (``data.preprocess.load_image``).
    Only the main thread calls these; the pool threads only decode. With
    tracing on, the main thread's wait on a decode is a ``decode.wait``
    span (``lane``: the loop's lane, for its attributes).
    """

    def __init__(self, traj: Trajectory, device: torch.device,
                 capacity: int, workers: int = 3, lane: int = 0):
        self._paths = traj.img_paths
        self._size = traj.img_size_wh
        # KITTI's centre crop after the resize (KittiTrajectory.raw_crop_w)
        self._crop_w = getattr(traj, "raw_crop_w", None)
        self._device = device
        self._lane = lane
        self._capacity = capacity
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._raw: "OrderedDict[int, Future]" = OrderedDict()
        self._dev: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        # divisors are tensors: CUDA divides by a Python scalar as a product
        # with its reciprocal, which rounds 126 of the 256 values u8/255
        # otherwise than a division does
        self._255 = _upload(np.float32(255.0), device)
        self._mean = _upload(pp.IMAGENET_MEAN, device)
        self._std = _upload(pp.IMAGENET_STD, device)

    def prefetch(self, upto: int) -> None:
        """Queue the decode of every frame up to ``upto`` not yet queued."""
        start = next(reversed(self._raw), -1) + 1
        for idx in range(start, min(upto, len(self._paths) - 1) + 1):
            self._raw[idx] = self._pool.submit(pp.load_raw, self._paths[idx],
                                               self._size, self._crop_w)
        while len(self._raw) > self._capacity:
            self._raw.popitem(last=False)

    def raw(self, idx: int) -> np.ndarray:
        with profiler.span("decode.wait", frame=idx, lane=self._lane,
                           device=self._device):
            return self._raw[idx].result()

    def get(self, idx: int) -> torch.Tensor:
        if idx not in self._dev:
            u8 = _upload(self.raw(idx), self._device)
            self._dev[idx] = (u8.to(torch.float32) / self._255
                              - self._mean) / self._std
            while len(self._dev) > self._capacity:
                self._dev.popitem(last=False)
        return self._dev[idx]

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def _export_chunk(entries, host: torch.Tensor, copied, device, parent):
    """Export worker: wait for the chunk's copy to the host, write its
    files, return ``(lane, scene_path_info row)`` per frame. Issues no CUDA
    work. Its spans (``export.chunk`` around ``export.copy_wait`` and an
    ``export.frame`` a frame) are children of ``parent``, the scene's."""
    with profiler.span("export.chunk", device=device, parent=parent):
        if copied is not None:
            with profiler.span("export.copy_wait"):
                copied.synchronize()
        dc = host.numpy().view(np.uint16)        # (2, n, H, W)
        for j, (lane, res_dir, batch_idx, raw, path) in enumerate(entries):
            with profiler.span("export.frame", frame=batch_idx, lane=lane,
                               device=device):
                export_frame(res_dir, batch_idx, raw, dc[0, j], dc[1, j])
    return [(lane, [batch_idx, path])
            for lane, _, batch_idx, _, path in entries]


class ChunkExporter:
    """Quantized maps on the device go to the files in chunks: every
    ``chunk`` frames queued on one device, ONE non-blocking copy into
    pinned memory, and an export thread waits on that copy's event and
    writes the chunk's files. The caller's thread waits only while
    ``in_flight`` chunks are still being written, counted over every lane
    and device, so the pinned memory in flight does not grow with the
    number of lanes (the loop gives 3 per device: in lockstep every device
    sends its chunk down on the same frame). ``wait_s`` sums the seconds
    the caller's thread waited for that bound (in ``add`` and ``submit``;
    ``finish``'s wait for the last chunks is not counted: with tracing on,
    the loop's ``scene.drain`` span holds it). With tracing on each wait
    for the bound is an ``export.wait`` span, and the export threads' spans
    are children of the span open where the exporter was made.

    ``res_dirs``: each lane's output directory (``add``'s ``lane``
    indexes the list)."""

    def __init__(self, res_dirs: list, chunk: int, in_flight: int = 3):
        self._res_dirs = list(res_dirs)
        self._chunk, self._in_flight = chunk, in_flight
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._futures: list = []
        self._queued: dict = {}       # device -> (entries, maps)
        self._rows = [[] for _ in self._res_dirs]  # rows of written chunks
        self._parent = profiler.current()
        self.wait_s = 0.0

    def add(self, frame_cnt: int, raw: np.ndarray, path: str,
            maps: torch.Tensor, lane: int = 0) -> None:
        """Queue one frame of ``lane``: ``maps`` (2, H, W) ``_q16`` depth
        and confidence on the device, ``raw`` its uint8 image."""
        entries, queued = self._queued.setdefault(maps.device, ([], []))
        entries.append((lane, self._res_dirs[lane], frame_cnt, raw, path))
        queued.append(maps)
        if len(entries) >= self._chunk:
            self._submit(maps.device)

    def _submit(self, device: torch.device) -> None:
        entries, queued = self._queued.pop(device)
        maps = torch.stack(queued, 1)                   # (2, n, H, W)
        if device.type == "cuda":
            host = torch.empty(maps.shape, dtype=maps.dtype, pin_memory=True)
            host.copy_(maps, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(device))
        else:
            host, copied = maps, None
        self._futures.append(self._pool.submit(_export_chunk, entries, host,
                                               copied, device, self._parent))
        while len(self._futures) > self._in_flight:
            with profiler.span("export.wait", device=device):
                t0 = time.perf_counter()
                self._collect(self._futures.pop(0))
                self.wait_s += time.perf_counter() - t0

    def _collect(self, future: Future) -> None:
        for lane, row in future.result():
            self._rows[lane].append(row)

    def submit(self) -> None:
        """Send every device's queued frames down, one chunk each."""
        for device in list(self._queued):
            self._submit(device)

    def finish(self) -> list:
        """Submit the rest, wait for every chunk; returns each lane's
        ``scene_path_info`` rows, in the order they were written."""
        self.submit()
        for f in self._futures:
            self._collect(f)
        self._futures = []
        return self._rows

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


class _Lane:
    """One trajectory of the loop on its device: its frames (decoded
    ahead, uploaded once), its poses (loaded without image decode;
    validity is FrameRecord.pose_valid's), its feature cache, its carry
    and its count of exported frames."""

    def __init__(self, traj: Trajectory, device: torch.device, span: int,
                 lead: int, capacity: int, index: int = 0):
        self.traj = traj
        self.exts = [np.asarray(traj.pose_loader(i)) for i in range(len(traj))]
        self.pose_ok = [bool(np.isfinite(e).all()) for e in self.exts]
        self.K = traj.K_dpv.astype(np.float32)
        self.end = len(traj) - span - 1     # one past its last reference
        self.frames = _FrameSource(traj, device, capacity=capacity,
                                   lane=index)
        self.features: "OrderedDict[int, tuple]" = OrderedDict()
        self.capacity = capacity
        self.carry: Optional[torch.Tensor] = None  # valid prediction (D, h, w)
        self.count = 0

    def window_ok(self, ref_indx: int, idxs) -> bool:
        return self.pose_ok[ref_indx] and all(self.pose_ok[i] for i in idxs)

    def feature(self, fe1, model: KVNet, idx: int) -> tuple:
        if idx not in self.features:
            # clones: a graphed extractor overwrites its outputs
            self.features[idx] = tuple(
                x.clone() for x in fe1(model, self.frames.get(idx)))
            while len(self.features) > self.capacity:
                self.features.popitem(last=False)
        return self.features[idx]


def _run_lanes(models: list, cfg: ModelConfig, trajs, res_dirs, t_win_r: int,
               step: int, verbose: bool, chunk_t: int, cache_features,
               tf32: bool, lockstep: bool, graph: Optional[bool]) -> list:
    """The loop of ``run_trajectory`` (one lane) and of
    ``run_trajectories_parallel`` (N lanes in lockstep). ``models`` holds
    one ``KVNet`` per device; lane i runs on ``models[i // (N /
    len(models))]``, and each device's ok lanes take one step call per
    lockstep frame. ``lockstep`` numbers each lane's files by its own count
    of exported frames (JAX's ``row_counts``) and writes JAX's lockstep
    ``scene_path_info.txt`` header; otherwise files go by the frame's
    place in the sweep, skipped frames included (JAX's ``frame_cnt``).
    Returns each lane's count of exported frames.

    With tracing on (``utils.profiler``) the call is a ``scene`` span, whose
    id every span under it carries as its request id (``scene``), export
    threads included. Under it, on the main thread: ``scene.setup`` (the
    step made, each lane's poses loaded and its frame source made), then per
    step call ``step.call`` (``frame``: the reference index; ``device``),
    the waits on a decoded frame (``decode.wait``) and on the exporter's
    bound (``export.wait``), and ``scene.drain`` (the exporter's last
    chunks written)."""
    with profiler.span("scene"):
        return _loop(models, cfg, trajs, res_dirs, t_win_r, step, verbose,
                     chunk_t, cache_features, tf32, lockstep, graph)


def _loop(models: list, cfg: ModelConfig, trajs, res_dirs, t_win_r: int,
          step: int, verbose: bool, chunk_t: int, cache_features,
          tf32: bool, lockstep: bool, graph: Optional[bool]) -> list:
    """``_run_lanes``'s body, inside its ``scene`` span."""
    graph = chunk_t > 1 if graph is None else graph
    D, V = cfg.ndepth, 2 * t_win_r
    w_dpv, h_dpv = trajs[0].dpv_size_wh
    span = t_win_r * step
    lo, hi = span, max(len(t) for t in trajs) - span - 1
    lead = span + 8                   # decode this many frames ahead
    capacity = 2 * (2 * span + 1 + lead)
    per_dev = len(trajs) // len(models)
    devices = [next(m.parameters()).device for m in models]
    uniform = {dev: torch.full((D, h_dpv, w_dpv), -math.log(D),
                               dtype=torch.float32, device=dev)
               for dev in set(devices)}
    for res_dir in res_dirs:
        os.makedirs(res_dir, exist_ok=True)

    lanes: list = []
    exporter = ChunkExporter(res_dirs, chunk_t,
                             in_flight=3 * len(set(devices)))
    try:
        with profiler.span("scene.setup"):
            infer_step = make_infer_step(cfg, tf32=tf32,
                                         with_features=bool(cache_features),
                                         graph=graph)
            fe1 = make_frame_features(tf32, graph=graph)
            captured = len(graph_mod.captures)
            for i, traj in enumerate(trajs):
                lanes.append(_Lane(traj, devices[i // per_dev], span, lead,
                                   capacity, i))
        for frame_cnt, ref_indx in enumerate(range(lo, hi)):
            idxs = window_indices(ref_indx, t_win_r, step)
            n_ok = 0
            for k, (model, dev) in enumerate(zip(models, devices)):
                ok = []
                for i in range(k * per_dev, (k + 1) * per_dev):
                    lane = lanes[i]
                    lane_ok = ref_indx < lane.end   # not past its end
                    if lane_ok:
                        lane.frames.prefetch(ref_indx + lead)
                        lane_ok = lane.window_ok(ref_indx, idxs)
                        if not lane_ok and verbose:
                            # invalid pose: skip the frame, reset the
                            # recurrence (test_KVNet.py:241-246)
                            where = f"lane {i} " if lockstep else ""
                            print(f"{where}frame {ref_indx}: invalid pose, "
                                  f"recurrence reset")
                    if lane_ok:
                        ok.append(i)
                    else:
                        lane.carry = None
                if not ok:
                    continue
                sel = [lanes[i] for i in ok]
                bv_valid = [lane.carry is not None for lane in sel]
                bv_predict = torch.stack([
                    uniform[dev] if lane.carry is None else lane.carry
                    for lane in sel])
                # the window's relative poses, the next one and K of every
                # lane: one copy a step
                poses = np.stack([[rel_pose(lane.exts[ref_indx],
                                            lane.exts[i]) for i in idxs]
                                  for lane in sel])
                nexts = np.stack([rel_pose(
                    lane.exts[ref_indx],
                    lane.exts[min(ref_indx + step, len(lane.traj) - 1)])
                    for lane in sel])
                Ks = np.stack([lane.K for lane in sel])
                geo = _upload(np.concatenate(
                    [poses.ravel(), nexts.ravel(), Ks.ravel()]), dev)
                a, b = poses.size, poses.size + nexts.size
                batch = {
                    "ref": torch.stack([lane.frames.get(ref_indx)
                                        for lane in sel]),
                    "srcs": torch.stack([torch.stack(
                        [lane.frames.get(i) for i in idxs]) for lane in sel]),
                    "poses": geo[:a].view(poses.shape),
                    "K": geo[b:].view(Ks.shape),
                    "pose_next": geo[a:b].view(nexts.shape),
                }
                feats = ()
                if cache_features:
                    windows = [[lane.feature(fe1, model, i)
                                for i in (*idxs, ref_indx)] for lane in sel]
                    feats = (tuple(torch.stack([torch.stack(
                        [f[j] for f in window]) for window in windows])
                        for j in (0, 1)),)
                with profiler.span("step.call", frame=ref_indx, device=dev):
                    out = infer_step(model, batch, bv_predict, bv_valid,
                                     *feats)
                # a graphed step overwrites its outputs at its next replay
                carry = out.bv_predict.clone() if graph else out.bv_predict
                for j, (i, lane) in enumerate(zip(ok, sel)):
                    lane.carry = carry[j]
                    exporter.add(lane.count if lockstep else frame_cnt,
                                 lane.frames.raw(ref_indx),
                                 lane.traj.img_paths[ref_indx],
                                 torch.stack([_q16(out.depth[j]),
                                              _q16(out.confidence[j])]),
                                 lane=i)
                    lane.count += 1
                n_ok += len(ok)
            if verbose and lockstep:
                print(f"Finished lockstep frame {frame_cnt + 1}/{hi - lo}: "
                      f"{n_ok}/{len(lanes)} lanes", flush=True)
            elif verbose and n_ok:
                print(f"Finished frame {frame_cnt + 1}/{hi - lo}", flush=True)
        with profiler.span("scene.drain"):
            rows = exporter.finish()
        if verbose and graph:
            print(f"captured {len(graph_mod.captures) - captured} step "
                  f"graph(s)", flush=True)
    finally:
        exporter.shutdown()
        for lane in lanes:
            lane.frames.close()
    for traj, res_dir, lane_rows in zip(trajs, res_dirs, rows):
        name = traj.name or os.path.dirname(traj.img_paths[0])
        # JAX's lockstep loop hands the name to save_scene_path_info as a
        # row (JAX infer/loop.py:773), so its header is the name's
        # characters two spaces apart; each loop keeps JAX's header
        scene_path_info = [name if lockstep else [name]]
        scene_path_info += sorted(lane_rows)
        save_scene_path_info(os.path.join(res_dir, "scene_path_info.txt"),
                             scene_path_info)
    return [lane.count for lane in lanes]


def _device_of(model: KVNet) -> torch.device:
    """Where ``model``'s parameters are: the device whose kind
    ``run_trajectories_parallel``'s mesh takes."""
    return next(model.parameters()).device


def run_trajectory(
    model: KVNet,
    cfg: ModelConfig,
    traj: Trajectory,
    res_dir: str,
    t_win_r: Optional[int] = None,
    step: int = 1,
    verbose: bool = True,
    chunk_t: int = 32,
    cache_features: Optional[bool] = None,
    tf32: bool = False,
    graph: Optional[bool] = None,
) -> int:
    """Returns the number of exported frames. Writes the full output
    contract (img/d/conf files + scene_path_info.txt) into ``res_dir``.

    The loop runs wherever ``model`` is (the card for a model built there).
    ``chunk_t``: frames per copy to the host. The maps of ``chunk_t``
    frames go down in one copy, which the export worker waits for; the
    main thread waits only while 3 chunks are still being written. As in
    JAX, ``chunk_t > 1`` runs the compiled step, each step call a replay
    of a captured graph, and ``chunk_t=1`` the eager per-frame step;
    ``graph`` (None: by ``chunk_t``) chooses either at any ``chunk_t``.
    ``cache_features=True``: featurize each frame once, when it first
    enters a window, with B=1 BatchNorm statistics, and gather each
    window's maps by frame index from a cache on the device (the
    deviation of ``make_rollout(cache_features=True)``; any window
    ``step``). None (JAX's auto default off a TPU) and False keep the
    reference's joint-window semantics. JAX's loop caches only in its
    chunked scan and ignores the flag at ``chunk_t=1``; here the cache
    applies at every ``chunk_t``.
    ``tf32``: see ``make_infer_step``; off, the loop is fp32.
    """
    if chunk_t < 1:
        raise ValueError(f"chunk_t must be >= 1, got {chunk_t}")
    t_win_r = t_win_r if t_win_r is not None else cfg.t_win_r
    return _run_lanes([model], cfg, [traj], [res_dir], t_win_r, step,
                      verbose, chunk_t, cache_features, tf32,
                      lockstep=False, graph=graph)[0]


def run_trajectories_parallel(
    model: KVNet,
    cfg: ModelConfig,
    trajs,
    res_dirs,
    mesh=None,
    t_win_r: Optional[int] = None,
    step: int = 1,
    verbose: bool = True,
    chunk_t: int = 32,
    cache_features: Optional[bool] = None,
    tf32: bool = False,
    graph: Optional[bool] = None,
) -> list:
    """Lockstep inference over trajectories (JAX ``infer/loop.py:719``;
    the reference also ran its test model under DataParallel,
    test_KVNet.py:163). Returns the per-trajectory exported-frame counts.

    The lanes step together over the reference frames of the longest
    trajectory. A lane past its own end, or whose window holds an invalid
    pose, skips its forward and is not exported, and its carry is invalid
    on the next frame: JAX's ``carry_valid[i] = lane_ok[i]``. Every lane
    writes its own contract into ``res_dirs[i]``, its files numbered by
    its own count of exported frames (JAX's ``row_counts``; a single
    ``run_trajectory`` numbers by the frame's place, skipped frames
    included), and its ``scene_path_info.txt`` header is JAX's lockstep
    one (the scene name's characters two spaces apart). The lanes must
    share ``dpv_size_wh``.

    The lanes run one per device of a data mesh, as JAX's do: a ``mesh``
    (``parallel.make_mesh``) holds a replica of ``model`` on each device
    (``parallel.replicate``; ``model`` itself on its own device), and lane
    i runs on device ``i // (N / n_dev)``, JAX's contiguous ``P("data")``
    blocks; N must divide evenly over the mesh. ``mesh=None`` takes JAX's:
    the largest divisor of N that fits the cards this process sees, one
    CPU device for a model on the CPU (``parallel.lane_mesh``); on one
    card, all lanes batch onto it. Each lockstep frame, one step call per
    device takes its active lanes (one forward per lane, ONE prediction
    launch), each device's calls issued in turn from this thread.

    ``chunk_t``: lane-frames per copy to the host, per device (at most 3
    chunks in flight per device). ``cache_features``: as
    ``run_trajectory``, each lane with its own feature cache. ``tf32``:
    see ``make_infer_step``. ``graph``: as ``run_trajectory``; ragged
    lanes add keys (each lane count and carry validity seen).
    """
    from neuralrgbd_tpu_torch.parallel.mesh import lane_mesh, replicate

    if chunk_t < 1:
        raise ValueError(f"chunk_t must be >= 1, got {chunk_t}")
    t_win_r = t_win_r if t_win_r is not None else cfg.t_win_r
    n = len(trajs)
    mesh = (lane_mesh(n, _device_of(model)) if mesh is None
            else list(mesh))
    if n % len(mesh):
        raise ValueError(
            f"{n} lanes do not divide evenly over the {len(mesh)}-device "
            f"mesh")
    if verbose:
        print(f"lockstep mesh: {len(mesh)} device(s) "
              f"{' '.join(map(str, mesh))}, {n // len(mesh)} lane(s) each",
              flush=True)
    assert all(t.dpv_size_wh == trajs[0].dpv_size_wh for t in trajs), \
        "lockstep lanes must share the operating point"
    return _run_lanes(replicate(model, mesh), cfg, trajs, res_dirs, t_win_r,
                      step, verbose, chunk_t, cache_features, tf32,
                      lockstep=True, graph=graph)

#!/usr/bin/env python3
"""Lockstep lanes over the cards of one host, held lane for lane: the
port's ``cli.test_kvnet --multi_device`` (``infer.loop.
run_trajectories_parallel``, whose ``mesh=None`` spreads the lanes over
the cards the process sees as JAX's does, ``parallel.lane_mesh``) at the
reference operating point: 384x256, D=64 on 96x64, 4 source views,
feature_dim 64, fp32, TF32 off, exact semantics, seeded weights,
``chunk_t`` 32 (each step call a CUDA graph replay).

    python3 lockstep_cards.py        # every card the process sees (>= 2)

Each lane's files are held, bit for bit, against that lane's own
``run_trajectory`` on ``cuda:0``: every card runs the same kernels and
deterministic cuDNN algorithms (``infer.step.step_numerics``), so any
difference is a fault, not a tolerance. Phases:

1. the cards (``nvidia-smi``'s name and power limit of each) and the
   kernels' build; each kernel wrapper launched on the last card from a
   thread on ``cuda:0`` at the operating point's shapes leaves the thread
   on ``cuda:0`` and agrees with its twin there (``chip_smoke.py``'s
   tolerances); and a probe of what the wrappers' ``torch.cuda.device``
   block repairs: the sweep's C entry called without it moves the thread
   to its card;
2. ``cli.test_kvnet --multi_device --traj_idx 0 1 2 3`` from a
   reference-style ``.tar`` on ragged ``write_plane_scene``s (24, 20, 16
   and 22 frames at 640x480, lane 1's frame 9 with a non-finite pose): the
   mesh it prints (JAX's rule: one lane a card on 4 cards), each
   replica's parameters on its card, each step call on its lanes' card,
   and per card the sweep (B1) launched once per active lane-frame and the
   prediction (B2) once per lockstep frame with an active lane, and the
   D-Net's conv kernel ``chip_smoke.FE_LAUNCHES`` times an active
   lane-frame; each lane's files equal its own run's;
3. ``run_trajectories_parallel(mesh=None)`` at N=8 (two lanes a card on
   4 cards, JAX's contiguous blocks; lengths 24, 20, 16, 22, 18, 24, 14
   and 20) and N=6 (the first six: 3 cards by JAX's rule), held as in 2;
4. ``parallel.make_sharded_infer_step`` on the mesh of every card
   (``replicate``, ``shard_batch``) over two chained steps of one 8-lane
   ``synthetic_batch`` window (no carry, then the first step's), eager and
   graphed: each lane's depth, confidence and carry equal, bit for bit,
   those of the eager one-card step over all 8 lanes;
5. times, in turns, twice, on equal lanes of one 48-frame scene: ms per
   lockstep frame (a CUDA event on each card after each of its step
   calls; per card the median interval of frames 2 on; a lockstep frame
   is its slowest card's) and lane-frames/s, on every card at N=4 and N=8
   through the CLI (N=4 also with the exporter's former bound, 3 chunks
   in flight over all cards), on one card at N=4 (lockstep) and at N=1
   (``run_trajectory``); the host's lockstep period (the first step call
   of one frame to the next's, median of frames 2 on); each run on the
   host clock; and the main thread's seconds in the exporter
   (``ChunkExporter.wait_s``) per lockstep frame.

Last, a probe of what ``infer.graph.StepGraph``'s capture stream per card
repairs: ``torch.cuda.graph`` with its own capture stream (one for the
process, made on the card current at its first capture) records nothing
of another card's work. The last line is one JSON object (``ok``, the
cards, the times). Exits non-zero if a check failed, and at once without
2 cards.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

import chip_smoke as smoke
from neuralrgbd_tpu_torch.cli import test_kvnet as cli_test_kvnet
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import (synthetic_batch,
                                                 write_plane_scene)
from neuralrgbd_tpu_torch.infer import loop as loop_mod
from neuralrgbd_tpu_torch.infer.step import make_infer_step
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import conv2d_bn as kconv2d
from neuralrgbd_tpu_torch.ops.cuda import conv3d as kconv
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep
from neuralrgbd_tpu_torch.parallel import mesh as mesh_mod
from neuralrgbd_tpu_torch.parallel.mesh import (make_mesh,
                                                make_sharded_infer_step,
                                                mesh_size, replicate,
                                                shard_batch)

CFG, IMG_HW, SEED = smoke.CFG, smoke.IMG_HW, smoke.SEED
check = smoke.check
# the ragged lanes: lane 1's frame 9 has a non-finite pose
LENGTHS = (24, 20, 16, 22, 18, 24, 14, 20)
INVALID = (1, 9)
TIME_FRAMES = 48          # the timing lanes: 43 lockstep frames each
TURNS = 2
INFER_KEYS = ("ref", "srcs", "poses", "K", "pose_next")
CARDS: list[str] = []     # nvidia-smi's "name, power.limit", one per card
HOME = torch.device("cuda", 0)   # the model's card, and the single runs'


def phase_cards() -> int:
    print("phase 1: the cards and the kernels", flush=True)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise SystemExit("lockstep_cards: needs 2 or more CUDA cards, this "
                         f"process sees {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    CARDS.extend(smi.stdout.strip().splitlines())
    for line in CARDS:
        print(line, flush=True)
    n = torch.cuda.device_count()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}, {n} "
          f"cards: {[torch.cuda.get_device_name(i) for i in range(n)]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    build.build()
    print(f"  built the kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return n


def conv2d_case(dev) -> tuple:
    """The D-Net's dilated 128 -> 128 conv (layer4's) at five frames of the
    operating point, (5, 128, 64, 96), on ``dev``: its input with a pending
    BatchNorm and ReLU, the conv's module and BatchNorm, and a skip of the
    output's shape."""
    g = torch.Generator().manual_seed(SEED)
    C, shape = 128, (5, 128, IMG_HW[0] // 4, IMG_HW[1] // 4)
    conv = torch.nn.Conv2d(C, C, 3, padding=2, dilation=2, bias=False)
    bn = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                          * (2.0 / (9 * C)) ** 0.5)
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(torch.rand(C, generator=g) - 0.5)
    pending = torch.stack([torch.randn(C, generator=g),
                           0.5 + torch.rand(C, generator=g),
                           torch.randn(C, generator=g)])
    a = kconv2d.Act(torch.randn(shape, generator=g).to(dev), pending.to(dev),
                    True)
    skip = torch.randn(shape, generator=g).to(dev)
    return a, conv.to(dev), bn.to(dev), skip


def kernel_cases(dev) -> list:
    """(name, kernel call, twin call, rtol, atol) at the operating point's
    shapes on ``dev``."""
    ref, srcs, coords = smoke.sweep_inputs(dev, smoke.translation_poses(dev))
    lv, poses, K, d = smoke.resample_inputs(dev, CFG.ndepth, 64, 96,
                                            kinds=smoke.POSES[:2])
    x, w = smoke.conv_inputs(dev, smoke.KNET_LAYER, CFG.kv_feature_dim)
    pad = -float(np.log(CFG.ndepth))
    a, conv, bn, skip = conv2d_case(dev)
    M = a.raw.shape[0] * a.raw.shape[2] * a.raw.shape[3]
    bm = kconv2d.TILES[kconv2d.config_for(M, conv.out_channels)][0]

    @torch.no_grad()
    def conv2d_kernel():
        y = kconv2d.conv_bn(a, conv, bn)
        return torch.cat([y.raw.flatten(), y.bn.flatten()])

    @torch.no_grad()
    def conv2d_twin():
        y, part = kconv2d.conv_plain(a, conv, True, bm)
        return torch.cat([y.flatten(),
                          kconv2d.finalize_plain(part, M, bm, bn).flatten()])

    with torch.no_grad():
        held = kconv2d.finalize_plain(
            kconv2d.tile_stats_plain(skip, bm), M, bm, bn)
    return [
        ("sweep_fused", lambda: ksweep.sweep_kernel(ref, srcs, coords, 10.0),
         lambda: ksweep.sweep_plain(ref, srcs, coords, 10.0),
         *smoke.TOL["cost"]),
        ("resample", lambda: kresample.predict_next_cuda(lv, poses, K, d, pad),
         lambda: kresample.predict_next_plain(lv, poses, K, d, pad),
         *smoke.TOL["resample"]),
        ("conv3d", lambda: kconv.conv3d_kernel(x, w, torch.float32),
         lambda: kconv.conv3d_plain(x, w, torch.float32),
         *smoke.CONV_TOL["fp32"]),
        # the conv with its tile statistics, and their finalize; the
        # residual add of a BatchNorm's output and a skip with its own
        ("conv2d_bn", conv2d_kernel, conv2d_twin, 1e-4, 1e-4),
        ("conv2d_bn residual",
         lambda: kconv2d.residual_kernel(skip, held, a),
         lambda: kconv2d.residual_plain(skip, held, a), 1e-5, 1e-5),
    ]


def probe_devices(n_cards: int) -> None:
    last = torch.device("cuda", n_cards - 1)
    for name, kern, twin, rtol, atol in kernel_cases(last):
        got = kern()
        on = torch.cuda.current_device()
        want = twin()
        torch.cuda.synchronize(last)
        check(on == 0 and got.device == last
              and smoke.within(got, want, rtol, atol),
              f"{name} launched on {last} from a thread on cuda:0: the "
              f"thread after it on cuda:{on}, max |kernel - twin| "
              f"{smoke.max_err(got, want):.3e} (rtol {rtol}, atol {atol})")
    # what the wrappers' torch.cuda.device block repairs: the C entry
    # makes its card current and leaves it so
    kern = kernel_cases(last)[0][1]
    with patched(torch.cuda, "device", _NoGuard):
        kern()
    moved = torch.cuda.current_device()
    torch.cuda.set_device(0)
    print(f"  probe: the sweep's C entry alone, launched on {last}, leaves "
          f"the thread on cuda:{moved}", flush=True)


def probe_capture_stream() -> None:
    """What ``StepGraph``'s capture stream per card repairs (run last: it
    leaves ``torch.cuda.graph``'s process-wide capture stream on
    ``cuda:0``)."""
    print("probe: torch.cuda.graph's own capture stream", flush=True)
    graphs, xs = [], []
    for k in (0, 1):
        xs.append(torch.zeros(1, device=f"cuda:{k}"))
        graphs.append(torch.cuda.CUDAGraph())
        try:
            with torch.cuda.device(k), \
                    torch.cuda.graph(graphs[k],
                                     capture_error_mode="thread_local"):
                xs[k] += 1
            for _ in range(3):
                graphs[k].replay()
            torch.cuda.synchronize(k)
            seen = (f"{float(xs[k])} (3.0: captured; 1.0: run once, "
                    f"outside the graph)")
        except RuntimeError as e:
            seen = f"raised {str(e).splitlines()[0]!r}"
        print(f"  a += 1 on cuda:{k} captured and replayed 3 times: {seen}",
              flush=True)
    torch.cuda.set_device(0)


class _NoGuard(contextlib.nullcontext):
    """``torch.cuda.device`` that leaves the current device alone (a type:
    torch's own code tests ``isinstance`` against it)."""

    def __init__(self, device):
        super().__init__()


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Call(NamedTuple):
    device: torch.device      # the batch's
    model_device: torch.device
    lanes: int
    b1: int                   # sweep launches inside the call
    b2: int                   # prediction launches inside the call
    start: float              # host clock at the call
    host_ms: float
    event: torch.cuda.Event   # recorded on the card's stream after it


class CardProbe:
    """Wraps ``make_infer_step`` where the loop calls it and records each
    step call (``Call``); the kernels' counters are host-side: no sync."""

    def __init__(self):
        self.calls: list[Call] = []

    def __enter__(self):
        self.make = loop_mod.make_infer_step

        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def probed(model, batch, bv_predict, bv_valid, *rest):
                dev = batch["ref"].device
                b1, b2 = ksweep.launches, kresample.launches
                t = time.perf_counter()
                out = step(model, batch, bv_predict, bv_valid, *rest)
                host = 1e3 * (time.perf_counter() - t)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(dev))
                self.calls.append(Call(
                    dev, next(model.parameters()).device, len(bv_valid),
                    ksweep.launches - b1, kresample.launches - b2, t, host,
                    ev))
                return out
            return probed

        loop_mod.make_infer_step = make
        return self

    def __exit__(self, *exc):
        loop_mod.make_infer_step = self.make

    def on(self, dev) -> list[Call]:
        return [c for c in self.calls if c.device == dev]

    def card_ms(self, dev) -> float:
        """The card's median frame period, frames 2 on."""
        calls = self.on(dev)
        torch.cuda.synchronize(dev)
        periods = [a.event.elapsed_time(b.event)
                   for a, b in zip(calls, calls[1:])]
        return statistics.median(periods[1:])

    def host_ms(self, first) -> float:
        """The host's lockstep period: the first card's step call of one
        frame to the next's, median of frames 2 on."""
        starts = [c.start for c in self.on(first)]
        return statistics.median(
            1e3 * (b - a) for a, b in list(zip(starts, starts[1:]))[1:])


class Replicas:
    """Records the replicas ``run_trajectories_parallel`` makes."""

    def __enter__(self):
        self.replicas, self.make = [], mesh_mod.replicate

        def kept(*args):
            self.replicas = self.make(*args)
            return self.replicas

        mesh_mod.replicate = kept
        return self

    def __exit__(self, *exc):
        mesh_mod.replicate = self.make


class Exporters:
    """Records each ``ChunkExporter`` the loop makes; ``in_flight`` forces
    its bound (None: the loop's)."""

    def __init__(self, in_flight=None):
        self.in_flight, self.made = in_flight, []

    def __enter__(self):
        self.cls = loop_mod.ChunkExporter
        outer = self

        class Recorded(self.cls):
            def __init__(self, res_dirs, chunk, in_flight=3):
                super().__init__(res_dirs, chunk,
                                 outer.in_flight or in_flight)
                outer.made.append(self)

        loop_mod.ChunkExporter = Recorded
        return self

    def __exit__(self, *exc):
        loop_mod.ChunkExporter = self.cls

    def wait_s(self) -> float:
        return sum(e.wait_s for e in self.made)


def write_lanes(root: str, lengths, invalid=None) -> list:
    """``write_plane_scene``s of ``lengths`` frames (scenes 0..), written
    on a thread pool; frame ``invalid[1]`` of lane ``invalid[0]`` given a
    non-finite pose. Their trajectories."""
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda k: write_plane_scene(root, k,
                                                  n_frames=lengths[k]),
                      range(len(lengths))))
    if invalid is not None:
        lane, frame = invalid
        with open(os.path.join(root, f"scene{lane:04d}_00",
                               f"frame-{5 * frame:06d}.pose.txt"), "w") as f:
            f.write(" ".join(["nan"] * 16) + "\n")
    return [make_trajectory(k, 5, root, img_size_wh=IMG_HW[::-1],
                            d_candi=CFG.d_candi) for k in range(len(lengths))]


def active_refs(traj) -> set:
    """The reference frames at which ``traj``'s lane steps: its windows
    whose poses are all finite."""
    r = CFG.t_win_r
    ok = [bool(np.isfinite(traj.pose_loader(i)).all())
          for i in range(len(traj))]
    return {ref for ref in range(r, len(traj) - r - 1)
            if all(ok[ref - r:ref + r + 1])}


def equals_solo(lane_dir: str, solo: str) -> bool:
    """A lockstep lane's files against its own ``run_trajectory``'s: the
    same frames in ``scene_path_info.txt`` (under JAX's lockstep header),
    every map and image equal byte for byte."""
    a, b = smoke.info_rows(lane_dir), smoke.info_rows(solo)
    names = [(f"{k}_{int(ra[0]):05d}.{e}", f"{k}_{int(rb[0]):05d}.{e}")
             for ra, rb in zip(a[1:], b[1:])
             for k, e in (("d", "pgm"), ("conf", "pgm"), ("img", "png"))]
    return (len(a) == len(b) and a[0] == list(b[0][0])
            and [r[1] for r in a[1:]] == [r[1] for r in b[1:]]
            and all(open(os.path.join(lane_dir, x), "rb").read()
                    == open(os.path.join(solo, y), "rb").read()
                    for x, y in names))


def hold_lanes(what: str, trajs, n_cards: int, probe: CardProbe,
               replicas: list, printed: str, counts: list, launches: dict,
               dirs: list, solos: list) -> None:
    """Every check of phases 2-3 on one lockstep run of ``trajs``."""
    n = len(trajs)
    d = mesh_size(n, n_cards)
    per = n // d
    mesh = [torch.device("cuda", k) for k in range(d)]
    active = [active_refs(t) for t in trajs]
    want_line = (f"lockstep mesh: {d} device(s) "
                 f"{' '.join(map(str, mesh))}, {per} lane(s) each")
    check(want_line in printed.splitlines(),
          f"{what}: prints {want_line!r}")
    check([next(r.parameters()).device for r in replicas] == mesh,
          f"{what}: replica k's parameters on cuda:k, "
          f"{[str(next(r.parameters()).device) for r in replicas]}")
    check(all(c.model_device == c.device for c in probe.calls)
          and {c.device for c in probe.calls} == set(mesh),
          f"{what}: each step call's model and batch on one card, the "
          f"calls on {sorted({str(c.device) for c in probe.calls})}")
    check(counts == [len(a) for a in active],
          f"{what}: per-lane exported frames {counts} (the valid windows)")
    b2_total = 0
    for k, dev in enumerate(mesh):
        lanes = range(k * per, (k + 1) * per)
        calls = probe.on(dev)
        frames = set().union(*(active[i] for i in lanes))
        b2_total += len(frames)
        b1, b2 = sum(c.b1 for c in calls), sum(c.b2 for c in calls)
        want_b1 = sum(len(active[i]) for i in lanes)
        check(all(c.b1 == c.lanes and c.b2 == 1 for c in calls)
              and b1 == want_b1 and b2 == len(calls) == len(frames),
              f"{what}: {dev} (lanes {list(lanes)}): B1 {b1} (want "
              f"{want_b1}, one per active lane-frame), B2 {b2} in "
              f"{len(calls)} step calls (want {len(frames)}, one per "
              f"lockstep frame with an active lane)")
    check(launches == smoke.expected_launches(sum(counts), b2_total),
          f"{what}: the run's launches {launches}")
    for i in range(n):
        check(equals_solo(dirs[i], solos[i]),
              f"{what}: lane {i} ({counts[i]} frames, on "
              f"cuda:{i // per}): its maps and images equal bit for bit "
              f"to its own run_trajectory's on cuda:0")


def reset_launches() -> None:
    for mod in smoke.KERNELS.values():
        mod.launches = 0


def read_launches() -> dict:
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)
    return {name: mod.launches for name, mod in smoke.KERNELS.items()}


def cli_args(root: str, ckpt: str, res: str, n: int) -> list[str]:
    return (smoke.loop_args(root, ckpt, res)
            + ["--multi_device", "--traj_idx", *map(str, range(n))])


def phase_cli(model, ckpt: str, trajs, root: str, solos, n_cards: int,
              tmp: str) -> None:
    print(f"phase 2: cli.test_kvnet --multi_device --traj_idx 0 1 2 3 on "
          f"write_plane_scenes of {LENGTHS[:4]} frames, lane "
          f"{INVALID[0]}'s frame {INVALID[1]} non-finite", flush=True)
    res = os.path.join(tmp, "cli")
    reset_launches()
    with CardProbe() as probe, Replicas() as rep:
        _, out = smoke.quiet(cli_test_kvnet.main,
                             cli_args(root, ckpt, res, 4))
    launches = read_launches()
    printed = [ln for ln in out.splitlines() if ln.startswith("trajectory")]
    counts = [int(ln.split()[3]) for ln in printed]
    print("  " + next(ln for ln in out.splitlines()
                      if ln.startswith("lockstep mesh")), flush=True)
    hold_lanes("N=4 CLI", trajs[:4], n_cards, probe, rep.replicas, out,
               counts, launches,
               [os.path.join(res, f"loop_{i}") for i in range(4)], solos)
    check(torch.cuda.current_device() == 0,
          f"the thread after the run on cuda:{torch.cuda.current_device()}")


def phase_lanes(model, trajs, solos, n_cards: int, tmp: str) -> None:
    for n in (8, 6):
        d = mesh_size(n, n_cards)
        print(f"phase 3: run_trajectories_parallel(mesh=None), N={n} on "
              f"{d} card(s), lanes of {LENGTHS[:n]} frames", flush=True)
        dirs = [os.path.join(tmp, f"lanes{n}", f"lane{i}") for i in range(n)]
        reset_launches()
        with CardProbe() as probe, Replicas() as rep:
            counts, out = smoke.quiet(loop_mod.run_trajectories_parallel,
                                      model, CFG, trajs[:n], dirs)
        launches = read_launches()
        check(rep.replicas[0] is model,
              f"N={n}: the model itself is the replica on its own card")
        hold_lanes(f"N={n}", trajs[:n], n_cards, probe, rep.replicas, out,
                   counts, launches, dirs, solos)


def phase_sharded(model, n_cards: int) -> None:
    print(f"phase 4: make_sharded_infer_step on {n_cards} cards, one "
          f"8-lane synthetic_batch window, two chained steps", flush=True)
    n = 8
    batch = {k: v for k, v in synthetic_batch(
        CFG, n_lanes=n, img_hw=IMG_HW, seed=SEED)[0].items()
        if k in INFER_KEYS}
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    bvp = np.full((n, CFG.ndepth, h, w), -np.log(CFG.ndepth), np.float32)
    dev0 = HOME
    one_step = make_infer_step(CFG)
    one_batch = {k: torch.from_numpy(v).to(dev0) for k, v in batch.items()}
    carry, ones = torch.from_numpy(bvp).to(dev0), []
    for valid in (False, True):
        out = one_step(model, one_batch, carry, [valid] * n)
        ones.append(out)
        carry = out.bv_predict
    d = mesh_size(n, n_cards)
    mesh = make_mesh(d)
    replicas = replicate(model, mesh)
    blocks = shard_batch(batch, mesh)
    for graph in (False, True):
        step = make_sharded_infer_step(CFG, mesh, graph=graph)
        carries = shard_batch(bvp, mesh)
        for t, valid in enumerate((False, True)):
            outs = step(replicas, blocks, carries,
                        shard_batch(np.full(n, valid), mesh))
            # a graphed step's outputs are its static buffers
            outs = [type(o)(*(x.clone() for x in o)) for o in outs]
            carries = [o.bv_predict for o in outs]
            want = ones[t]
            equal = all(
                torch.equal(getattr(o, f).cpu(),
                            getattr(want, f)[k * (n // d):(k + 1) * (n // d)]
                            .cpu())
                for k, o in enumerate(outs)
                for f in ("depth", "confidence", "bv_predict"))
            check(equal and [o.depth.device for o in outs] == mesh,
                  f"{'graphed' if graph else 'eager'} step {t + 1} on "
                  f"{d} cards ({n // d} lanes each): every lane's depth, "
                  f"confidence and carry equal the one-card step's bit "
                  f"for bit")


def timed_run(kind: str, model, ckpt: str, root: str, trajs, tmp: str,
              tag: str, in_flight=None) -> dict:
    """One timed run of ``kind``: "cards" (the CLI over every card),
    "one card" (``run_trajectories_parallel`` on ``cuda:0``) or "single"
    (``run_trajectory``)."""
    n = len(trajs)
    res = os.path.join(tmp, "time", tag)
    with CardProbe() as probe, Exporters(in_flight) as ex:
        t0 = time.perf_counter()
        if kind == "cards":
            smoke.quiet(cli_test_kvnet.main, cli_args(root, ckpt, res, n))
        elif kind == "one card":
            loop_mod.run_trajectories_parallel(
                model, CFG, trajs, [f"{res}_{i}" for i in range(n)],
                mesh=make_mesh(1), verbose=False)
        else:
            loop_mod.run_trajectory(model, CFG, trajs[0], res,
                                    verbose=False)
        wall = time.perf_counter() - t0
    cards = sorted({c.device for c in probe.calls}, key=str)
    per_card = [probe.card_ms(dev) for dev in cards]
    frames = len(probe.on(cards[0]))
    lock_ms = max(per_card)
    return {"lanes": n, "cards": len(cards), "ms": lock_ms,
            "per_card_ms": per_card, "lane_frames_s": 1e3 * n / lock_ms,
            "host_ms": probe.host_ms(cards[0]), "wall_s": wall,
            "wall_lane_frames_s": n * frames / wall,
            "export_wait_ms": 1e3 * ex.wait_s() / frames,
            "in_flight": ex.made[0]._in_flight}


def phase_times(model, ckpt: str, n_cards: int, tmp: str) -> dict:
    print(f"phase 5: times on equal {TIME_FRAMES}-frame lanes, in turns, "
          f"{TURNS} times", flush=True)
    root = os.path.join(tmp, "time_scenes")
    write_plane_scene(root, 0, n_frames=TIME_FRAMES)
    for k in range(1, 8):           # one scene, read as 8 lanes
        os.symlink(os.path.join(root, "scene0000_00"),
                   os.path.join(root, f"scene{k:04d}_00"))
    trajs = [make_trajectory(k, 5, root, img_size_wh=IMG_HW[::-1],
                             d_candi=CFG.d_candi) for k in range(8)]
    arms = {
        f"{n_cards} cards, N=4": ("cards", 4, None),
        f"{n_cards} cards, N=4, 3 chunks in flight": ("cards", 4, 3),
        f"{n_cards} cards, N=8": ("cards", 8, None),
        "1 card, N=4 lockstep": ("one card", 4, None),
        "1 card, N=1": ("single", 1, None),
    }
    runs = {name: [] for name in arms}
    for turn in range(TURNS):
        for name, (kind, n, bound) in arms.items():
            runs[name].append(timed_run(kind, model, ckpt, root, trajs[:n],
                                        tmp, f"{turn}_{len(runs[name])}"
                                        f"_{kind}_{n}_{bound}", bound))
    for name, rs in runs.items():
        print(f"  {CARDS[0]}: {name}: "
              + " / ".join(f"{r['ms']:.3f}" for r in rs)
              + f" ms per lockstep frame (cards "
              + " / ".join("[" + ", ".join(f"{x:.3f}" for x in r[
                  'per_card_ms']) + "]" for r in rs)
              + "), " + " / ".join(f"{r['lane_frames_s']:.2f}" for r in rs)
              + " lane-frames/s; host period "
              + " / ".join(f"{r['host_ms']:.3f}" for r in rs)
              + " ms; the run "
              + " / ".join(f"{r['wall_s']:.2f}" for r in rs)
              + " s on the host clock ("
              + " / ".join(f"{r['wall_lane_frames_s']:.2f}" for r in rs)
              + " lane-frames/s); the exporter's wait "
              + " / ".join(f"{r['export_wait_ms']:.3f}" for r in rs)
              + f" ms per lockstep frame (bound {rs[0]['in_flight']} "
              f"chunks)", flush=True)
    base = statistics.median(r["lane_frames_s"] for r in runs["1 card, N=1"])
    for name, rs in runs.items():
        print(f"  {name}: {statistics.median(r['lane_frames_s'] for r in rs) / base:.3f}x "
              f"one card's lane-frames/s at N=1", flush=True)
    return runs


def main() -> int:
    n_cards = phase_cards()
    probe_devices(n_cards)
    tmp = tempfile.mkdtemp(prefix="lockstep_cards_")
    root = os.path.join(tmp, "scenes")
    t0 = time.perf_counter()
    trajs = write_lanes(root, LENGTHS, invalid=INVALID)
    model = KVNet(CFG, device=HOME, seed=SEED, single_refine=True)
    ckpt = os.path.join(tmp, "kvnet.tar")
    torch.save({"state_dict": {f"module.{k}": v.cpu()
                               for k, v in model.state_dict().items()}}, ckpt)
    solos = [os.path.join(tmp, "solo", f"lane{i}") for i in range(8)]
    for traj, solo in zip(trajs, solos):
        loop_mod.run_trajectory(model, CFG, traj, solo, verbose=False)
    print(f"  the scenes, the checkpoint and 8 single runs on cuda:0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phases = [lambda: phase_cli(model, ckpt, trajs, root, solos, n_cards,
                                tmp),
              lambda: phase_lanes(model, trajs, solos, n_cards, tmp),
              lambda: phase_sharded(model, n_cards)]
    for phase in phases:
        try:
            phase()
        except Exception as e:      # a phase that raises fails the run
            import traceback

            traceback.print_exc()
            check(False, f"a phase raised {type(e).__name__}: {e}")
    times = phase_times(model, ckpt, n_cards, tmp)
    probe_capture_stream()
    ok = not smoke.failures
    if not ok:
        print(f"FAILED: {smoke.failures}", flush=True)
    print(json.dumps({"ok": ok, "cards": CARDS, "times": times}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

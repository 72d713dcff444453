"""What decides ``correct``: the maps that the timed path wrote, held
against the plain reference run over the same scene files with the same
weights.

For each frame of a sampled lane: the mean |depth - reference depth| in mm
and the mean |confidence - reference confidence| in thousandths, over
every pixel, both on the export's 16-bit quantization. Two numbers are
read from them, each the worst frame's:

- over the scene's first chunk (its first ``chunk_t`` frames), the gaps
  themselves (``depth_mm_first_chunk``, ``conf_milli_first_chunk``);
- over every frame, the gaps divided by the number of frames the carried
  prediction has run through, 1 on a scene's first frame
  (``depth_mm_per_step``, ``conf_milli_per_step``).

The step is recurrent and its random-weight dynamics are chaotic: a
rounding difference of the program's kernels grows frame by frame (on
some seeds to 3 mm by a 150th frame, where on others it stays under
0.5 mm), while a lower precision is off by ~0.5 mm from the first frame
and by 5 mm or more within the first chunk. Over the first chunk the
program's own gaps are still small, and the raw gap holds those frames
tightly; later frames are held per frame of carry, so a fault there is
caught only where its gap passes the limit times the frames of carry.
A run's numbers are the worst frame's of each, and the count of frames the
reference expects that have no files; each is held to its limit in
``checks/<cell>.json``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.reference import kvnet as ref_kvnet
from benchmark.reference import scenes as ref_scenes

NAMES = ("depth_mm_first_chunk", "conf_milli_first_chunk",
         "depth_mm_per_step", "conf_milli_per_step", "missing_frames")


def read_pgm(path: str) -> np.ndarray:
    """A 16-bit binary PGM (the export's ``P5``, maxval 65535)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval = data.split(maxsplit=4)[:4]
    if magic != b"P5" or maxval != b"65535":
        raise ValueError(f"{path}: not a 16-bit binary PGM")
    n = 2 * int(w) * int(h)       # the raster: the file's last n bytes
    return np.frombuffer(data[len(data) - n:], ">u2").reshape(int(h), int(w))


def files_of(res_dir: str):
    """``got(frame)`` -> (depth, confidence) uint16 maps, or None."""
    def got(frame):
        try:
            return tuple(read_pgm(os.path.join(
                res_dir, f"{k}_{frame:05d}.pgm")) for k in ("d", "conf"))
        except FileNotFoundError:
            return None
    return got


def reference_scene(cfg: dict, root: str, index: int):
    """The reference's reading of scene ``index`` of ``root``."""
    data = cfg["data"]
    if data["kind"] == "scannet":
        return ref_scenes.scannet_scene(
            os.path.join(root, f"scene{index:04d}_00"), data["img_wh"])
    return ref_scenes.kitti_drive(root, index, data["img_wh"],
                                  data.get("crop_w"))


def compare(expected, got) -> tuple:
    """[(frame, depth mm, conf milli, steps)] of every (frame, depth,
    confidence, steps) of ``expected`` against ``got(frame)``, and the
    frames with no output."""
    stats, missing = [], 0
    for frame, d_ref, c_ref, steps in expected:
        out = got(frame)
        if out is None or out[0].shape != d_ref.shape:
            missing += 1
            continue
        d, c = (x.astype(np.int64) for x in out)
        stats.append((frame,
                      float(np.abs(d - d_ref.astype(np.int64)).mean()),
                      float(np.abs(c - c_ref.astype(np.int64)).mean()),
                      steps))
    return stats, missing


def frame_stats(reference, scene, got) -> tuple:
    """``compare`` over every frame the reference runs on ``scene``."""
    return compare(reference.run(scene), got)


def _readings(stat: tuple, chunk_t: int) -> dict:
    """{name: value} of one frame's (frame, depth, conf, steps): the raw
    gaps on the scene's first chunk, the gaps per frame of carry on all."""
    _, d, c, n = stat
    out = {"depth_mm_per_step": d / n, "conf_milli_per_step": c / n}
    if n <= chunk_t:
        out.update(depth_mm_first_chunk=d, conf_milli_first_chunk=c)
    return out


def judge(stats: list, missing: int, limits: dict, chunk_t: int) -> dict:
    """{name: (value, limit)} of the run's compared numbers."""
    out = {m: (0.0, limits[m]) for m in NAMES if m != "missing_frames"}
    for s in stats:
        for m, v in _readings(s, chunk_t).items():
            out[m] = (max(out[m][0], v), limits[m])
    out["missing_frames"] = (missing, 0)
    return out


def failed_frames(stats: list, missing: int, limits: dict,
                  chunk_t: int) -> int:
    """The frames without files, and those beyond a limit."""
    return missing + sum(
        1 for s in stats
        if any(v > limits[m] for m, v in _readings(s, chunk_t).items()))


def check_lanes(cfg: dict, weights: dict, lanes: list, devices,
                precision: str = "fp32") -> tuple:
    """The reference over each sampled lane, ``lanes`` a list of (scenes'
    root, scene index, ``got``), lane i on ``devices[i % n]`` (one thread
    a device). Returns (stats over all lanes, missing)."""
    refs = {dev: ref_kvnet.Reference(weights, cfg["model"], dev, precision)
            for dev in devices[:len(lanes)]}
    for dev in refs:
        # torch.linalg loads its solver lazily, and that load is not safe
        # to make from two threads at once: make it here, once
        torch.linalg.inv(torch.eye(4, device=dev))

    def one(i):
        root, index, got = lanes[i]
        dev = devices[i % len(devices)]
        return frame_stats(refs[dev], reference_scene(cfg, root, index), got)

    with ref_kvnet.numerics(precision), \
            ThreadPoolExecutor(max_workers=len(refs)) as pool:
        results = list(pool.map(one, range(len(lanes))))
    return ([s for r in results for s in r[0]],
            sum(r[1] for r in results))

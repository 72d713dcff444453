"""ScanNet data layer.

Reads the on-disk layout produced by the SensReader decode step
(``frame-%06d.{color.jpg,depth.pgm,pose.txt}`` + ``_info.txt``, written by
``third_party/SensReader`` — our C++ clone lives in native/sensreader).
Path/semantics parity with ``mdataloader/scanNet.py``.

Copy of ``neuralrgbd_tpu/data/scannet.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import glob
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from neuralrgbd_tpu_torch.data.trajectory import Trajectory


def read_split_file(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def get_paths(traj_indx: int, frame_interval: int = 5,
              database_path_base: str = "/datasets/scan-net-5-frame",
              split_txt: Optional[str] = None):
    """(scene_dir | n_scenes, img_paths, dmap_paths, pose_paths, info_path)
    — same contract as scanNet.get_paths (scanNet.py:108-162), including the
    quirk that the first return is the split size when split_txt is given."""
    assert frame_interval % 5 == 0 and frame_interval > 0, \
        "frame_interval must be a positive multiple of 5 (decode stride)"
    if split_txt is None:
        traj_paths = sorted(glob.glob(database_path_base + "/scene*"))
        first_ret = None
    else:
        scenes = read_split_file(split_txt)
        traj_paths = [os.path.join(database_path_base, s) for s in scenes]
        first_ret = len(scenes)
    if not traj_paths:
        raise FileNotFoundError(
            f"no ScanNet scenes (scene*) found under {database_path_base!r}"
        )
    if traj_indx >= len(traj_paths):
        raise IndexError(
            f"traj_indx {traj_indx} out of range: only {len(traj_paths)} "
            f"scenes under {database_path_base!r}"
        )
    fldr = traj_paths[traj_indx]
    nimg = len(glob.glob(f"{fldr}/*.jpg"))
    n = int((nimg - 1) / (frame_interval / 5)) + 1
    img_paths, dmap_paths, pose_paths = [], [], []
    for i in range(n):
        stem = f"{fldr}/frame-{i * frame_interval:06d}"
        img_paths.append(stem + ".color.jpg")
        dmap_paths.append(stem + ".depth.pgm")
        pose_paths.append(stem + ".pose.txt")
    return (first_ret or fldr), img_paths, dmap_paths, pose_paths, \
        fldr + "/_info.txt"


def read_info_txt(path: str) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Parse the SensReader ``_info.txt``: returns (K 3x3, (width, height)).

    Asserts the exact key layout the decoder writes (scanNet.py:224-236)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    assert lines[2].split("=")[0].strip() == "m_colorWidth", \
        "un-recognized _info.txt format"
    width = int(lines[2].split("=")[1])
    assert lines[3].split("=")[0].strip() == "m_colorHeight", \
        "un-recognized _info.txt format"
    height = int(lines[3].split("=")[1])
    assert lines[7].split("=")[0].strip() == "m_calibrationColorIntrinsic", \
        "un-recognized _info.txt format"
    vals = [float(x) for x in lines[7].split("=")[1].split()]
    K = np.asarray(vals, np.float64).reshape(4, 4)[:3, :3]
    return K, (width, height)


def read_pose_txt(path: str) -> np.ndarray:
    """4x4 cam-to-world from the decoder, inverted to world->cam
    (scanNet.py:186-202). May contain inf/nan (invalid tracked pose) —
    propagated as non-finite so the validity gate can reset the recurrence.
    A missing or malformed pose file is treated the same way (invalid
    pose -> lane skipped + recurrence reset) instead of crashing mid-run."""
    try:
        M = np.loadtxt(path).reshape(4, 4)
    except (OSError, ValueError):
        return np.full((4, 4), np.nan)
    if not np.isfinite(M).all():
        return np.full((4, 4), np.nan)
    try:
        return np.linalg.inv(M)
    except np.linalg.LinAlgError:
        return np.full((4, 4), np.nan)


def make_trajectory(traj_indx: int, frame_interval: int = 5,
                    database_path_base: str = "/datasets/scan-net-5-frame",
                    split_txt: Optional[str] = None,
                    img_size_wh=(384, 256), dpv_scale: float = 0.25,
                    d_candi: Optional[np.ndarray] = None,
                    up4_labels: bool = False) -> Trajectory:
    _, imgs, dmaps, poses, info = get_paths(
        traj_indx, frame_interval, database_path_base, split_txt
    )
    K, orig_wh = read_info_txt(info)
    return Trajectory(
        img_paths=imgs,
        dmap_paths=dmaps,
        pose_loader=lambda i: read_pose_txt(poses[i]),
        K_orig=K,
        orig_wh=orig_wh,
        img_size_wh=img_size_wh,
        dpv_scale=dpv_scale,
        d_candi=d_candi,
        depth_scale=0.001,
        name=os.path.basename(os.path.dirname(imgs[0])),
        up4_labels=up4_labels,
    )


def n_trajectories(database_path_base: str,
                   split_txt: Optional[str] = None) -> int:
    if split_txt is not None:
        return len(read_split_file(split_txt))
    return len(glob.glob(database_path_base + "/scene*"))

"""7Scenes data layer (reference: mdataloader/dl_7scenes.py).

Layout: <root>/<scene>/seq-XX/frame-%06d.{color.png,depth.png,pose.txt}.
Fixed Kinect intrinsics f=585, c=(320, 240) at 640x480
(dl_7scenes.py:156-163); depth png in mm with 65535 = invalid
(dl_7scenes.py:297-299); poses inverted to world->cam like ScanNet.

Copy of ``neuralrgbd_tpu/data/sevenscenes.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from neuralrgbd_tpu_torch.data.scannet import read_pose_txt
from neuralrgbd_tpu_torch.data.trajectory import Trajectory

K_7SCENES = np.array(
    [[585.0, 0.0, 320.0], [0.0, 585.0, 240.0], [0.0, 0.0, 1.0]], np.float64
)
ORIG_WH = (640, 480)


def get_seq_dirs(database_path_base: str) -> List[str]:
    """All seq-* trajectory folders, recursively (dl_7scenes.py:119-126).

    Unlike the reference's bare char-class glob, non-directories are
    filtered out, so stray ``seq-01.zip`` archives or notes files sitting
    next to the extracted sequences can't become phantom trajectories."""
    return sorted(
        d for d in glob.glob(f"{database_path_base}/**/seq*",
                             recursive=True)
        if os.path.isdir(d)
    )


def get_paths(traj_indx: int, database_path_base: str,
              dat_indx_step: int = 1):
    fldr = get_seq_dirs(database_path_base)[traj_indx]
    nimg = len(glob.glob(f"{fldr}/*.color.png"))
    idxs = range(0, nimg, dat_indx_step)
    imgs = [f"{fldr}/frame-{i:06d}.color.png" for i in idxs]
    dmaps = [f"{fldr}/frame-{i:06d}.depth.png" for i in idxs]
    poses = [f"{fldr}/frame-{i:06d}.pose.txt" for i in idxs]
    return fldr, imgs, dmaps, poses


def make_trajectory(traj_indx: int, database_path_base: str,
                    dat_indx_step: int = 1,
                    img_size_wh=(384, 256), dpv_scale: float = 0.25,
                    d_candi: Optional[np.ndarray] = None) -> Trajectory:
    fldr, imgs, dmaps, poses = get_paths(traj_indx, database_path_base,
                                         dat_indx_step)
    return Trajectory(
        img_paths=imgs,
        dmap_paths=dmaps,
        pose_loader=lambda i: read_pose_txt(poses[i]),
        K_orig=K_7SCENES,
        orig_wh=ORIG_WH,
        img_size_wh=img_size_wh,
        dpv_scale=dpv_scale,
        d_candi=d_candi,
        depth_scale=0.001,
        depth_invalid_above_mm=65530,
        name=os.path.basename(fldr),
    )


def n_trajectories(database_path_base: str) -> int:
    return len(get_seq_dirs(database_path_base))

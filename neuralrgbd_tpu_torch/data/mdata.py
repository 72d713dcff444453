"""Single-folder (pose-free) loader — reference ``mdataloader/mdata.py``.

Images by glob pattern only; intrinsics from a .mat/.json/.npz with keys
``IntM`` (3x3 or 3x4) and ``img_size`` (w, h) (mdata.py:71-121). Used by the
DSO + LBA pipeline, which estimates poses itself.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional, Tuple

import numpy as np

from neuralrgbd_tpu_torch.data.trajectory import Trajectory


def load_intrinsics_file(path: str) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Returns (K 3x3, (width, height)) from .mat / .npz / .json."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        import scipy.io as sio

        m = sio.loadmat(path)
        K = np.asarray(m["IntM"], np.float64)
        wh = np.asarray(m["img_size"]).ravel()
    elif ext == ".npz":
        m = np.load(path)
        K = np.asarray(m["IntM"], np.float64)
        wh = np.asarray(m["img_size"]).ravel()
    elif ext == ".json":
        with open(path) as f:
            m = json.load(f)
        K = np.asarray(m["IntM"], np.float64)
        wh = np.asarray(m["img_size"]).ravel()
    else:
        raise ValueError(f"unsupported intrinsics file: {path}")
    return K[:3, :3], (int(wh[0]), int(wh[1]))


def make_trajectory(img_glob: str, intrinsics_path: str,
                    img_size_wh=(384, 256), dpv_scale: float = 0.25,
                    d_candi: Optional[np.ndarray] = None,
                    poses=None) -> Trajectory:
    """``poses``: optional list of world->cam 4x4 (e.g. DSO-derived); frames
    whose pose is unavailable get NaN so the validity gate skips them."""
    img_paths = sorted(glob.glob(img_glob))
    if not img_paths:
        raise FileNotFoundError(f"no images match {img_glob!r}")
    K, orig_wh = load_intrinsics_file(intrinsics_path)

    def pose_loader(i):
        if poses is None:
            return np.eye(4)
        p = poses[i] if i < len(poses) else -1
        return p if isinstance(p, np.ndarray) else np.full((4, 4), np.nan)

    return Trajectory(
        img_paths=img_paths,
        pose_loader=pose_loader,
        K_orig=K,
        orig_wh=orig_wh,
        img_size_wh=img_size_wh,
        dpv_scale=dpv_scale,
        d_candi=d_candi,
        name=os.path.basename(os.path.dirname(img_paths[0])),
    )

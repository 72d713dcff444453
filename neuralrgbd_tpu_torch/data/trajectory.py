"""Trajectory dataset: per-frame records + window batch assembly.

One class serves every dataset family (ScanNet / 7Scenes / KITTI /
single-folder); the per-dataset modules only provide path globbing,
intrinsics, and depth-decoding knobs. This replaces the reference's four
near-identical ``torch.utils.data.Dataset`` subclasses (scanNet.py:358-452,
dl_7scenes.py:282-377, kitti.py, mdata.py) with one numpy pipeline whose
output feeds the inference step directly.

Copy of ``neuralrgbd_tpu/data/trajectory.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from neuralrgbd_tpu_torch.data import preprocess as pp
from neuralrgbd_tpu_torch.ops.camera import rescale_K


@dataclasses.dataclass
class FrameRecord:
    """Everything one frame contributes to a window batch + export."""

    img: np.ndarray                 # (H, W, 3) normalized float32
    img_raw: np.ndarray             # (H, W, 3) uint8 (for export)
    ext_M: np.ndarray               # (4, 4) world->cam extrinsic (float64)
    img_path: str
    dmap: Optional[np.ndarray] = None            # (h, w) meters at DPV res
    dmap_digit: Optional[np.ndarray] = None      # (h, w) int32 bins
    dmap_up4_imgsize_digit: Optional[np.ndarray] = None  # (H, W) 4*D bins
    dmap_imgsize: Optional[np.ndarray] = None    # (H, W) meters
    dmap_imgsize_digit: Optional[np.ndarray] = None  # (H, W) int32 bins

    @property
    def pose_valid(self) -> bool:
        return bool(np.isfinite(self.ext_M).all())


class Trajectory:
    """Lazy per-frame loader with a small LRU cache (sliding windows only
    move forward, so the cache stays at ~window size)."""

    def __init__(
        self,
        img_paths: Sequence[str],
        pose_loader: Callable[[int], np.ndarray],
        K_orig: np.ndarray,
        orig_wh: Tuple[int, int],
        img_size_wh: Tuple[int, int] = (384, 256),
        dpv_scale: float = 0.25,
        d_candi: Optional[np.ndarray] = None,
        dmap_paths: Optional[Sequence[str]] = None,
        depth_scale: float = 0.001,
        depth_invalid_above_mm: Optional[int] = None,
        depth_loader: Optional[Callable[[int], np.ndarray]] = None,
        cache_size: int = 8,
        name: str = "",
        up4_labels: bool = False,
    ):
        self.img_paths = list(img_paths)
        self.dmap_paths = list(dmap_paths) if dmap_paths is not None else None
        self.pose_loader = pose_loader
        self.depth_loader = depth_loader
        self.K_orig = np.asarray(K_orig, np.float64)
        self.orig_wh = orig_wh
        self.img_size_wh = img_size_wh
        self.dpv_scale = dpv_scale
        self.d_candi = d_candi
        # refine_dup label grid (scanNet.py:327): linspace over the same
        # [min, max] at 4x the bin count
        self.d_candi_up4 = (
            np.linspace(np.min(d_candi), np.max(d_candi),
                        4 * len(d_candi)).astype(np.float32)
            if (up4_labels and d_candi is not None) else None)
        self.depth_scale = depth_scale
        self.depth_invalid_above_mm = depth_invalid_above_mm
        self.name = name
        # post-resize center crop the raw-decode worker task must apply
        # (KittiTrajectory sets this; see preprocess.load_raw)
        self.raw_crop_w: Optional[int] = None
        self._cache: OrderedDict[int, FrameRecord] = OrderedDict()
        self._cache_size = cache_size
        # frame() is called concurrently by the inference loop's decode
        # prefetcher (infer/loop.py) and the main dispatch thread
        self._cache_lock = threading.RLock()

        W, H = img_size_wh
        self.dpv_size_wh = (int(W * dpv_scale), int(H * dpv_scale))
        # K at DPV resolution — what the sweep/resample consume
        # (two dataset instances in the reference, test_KVNet.py:138-154)
        self.K_dpv = rescale_K(self.K_orig, orig_wh, self.dpv_size_wh)
        self.K_img = rescale_K(self.K_orig, orig_wh, img_size_wh)

    def enable_up4_labels(self) -> "Trajectory":
        """Turn on refine_dup 4*D-bin labels post-construction (dataset
        factories that predate the flag call this; clears the frame cache
        so already-decoded records pick the labels up)."""
        if self.d_candi is not None and self.d_candi_up4 is None:
            self.d_candi_up4 = np.linspace(
                np.min(self.d_candi), np.max(self.d_candi),
                4 * len(self.d_candi)).astype(np.float32)
            with self._cache_lock:
                self._cache.clear()
        return self

    def __len__(self) -> int:
        return len(self.img_paths)

    def frame(self, idx: int) -> FrameRecord:
        with self._cache_lock:
            if idx in self._cache:
                return self._cache[idx]
        rec = self._load(idx)           # decode outside the lock
        with self._cache_lock:
            self._cache[idx] = rec
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return rec

    def refresh_poses(self) -> None:
        """Re-read poses into cached records without re-decoding images.

        The LBA pipeline mutates the trajectory's poses after every frame
        (test_KVNet_LBA.py:504-512); this keeps the image/depth cache warm
        while picking up the new extrinsics."""
        for idx, rec in self._cache.items():
            rec.ext_M = self.pose_loader(idx)

    def _load(self, idx: int) -> FrameRecord:
        img, raw = pp.load_image(self.img_paths[idx], self.img_size_wh)
        ext_M = self.pose_loader(idx)

        dmap = dmap_digit = dmap_imgsize = dmap_imgsize_digit = None
        dmap_up4_imgsize_digit = None
        full = None
        if self.depth_loader is not None:
            full = self.depth_loader(idx)
        elif self.dmap_paths is not None:
            try:
                full = pp.load_depth(self.dmap_paths[idx], self.depth_scale,
                                     self.depth_invalid_above_mm)
            except OSError:
                # missing/corrupt GT depth: all-invalid map (digitizes to
                # the ignore bin -> zero loss weight), same policy as the
                # KITTI benchmark-GT gap handling (kitti.py)
                full = np.zeros(self.img_size_wh[::-1], np.float32)
        if full is not None:
            invalid = full < 0.01  # scanNet.py:371-373
            full = pp.apply_invalid_mask(full, invalid)
            dmap_imgsize = pp.resize_nearest(full, self.img_size_wh)
            dmap = pp.resize_nearest(full, self.dpv_size_wh)
            if self.d_candi is not None:
                dmap_digit = pp.digitize_depth(dmap, self.d_candi)
                dmap_imgsize_digit = pp.digitize_depth(dmap_imgsize, self.d_candi)
                if self.d_candi_up4 is not None:
                    # scanNet.py:419-422: digitize vs the 4*D grid, clamped
                    # to [0, 4D-1] (digitize_depth already clamps)
                    dmap_up4_imgsize_digit = pp.digitize_depth(
                        dmap_imgsize, self.d_candi_up4)

        return FrameRecord(
            img=img, img_raw=raw, ext_M=ext_M, img_path=self.img_paths[idx],
            dmap=dmap, dmap_digit=dmap_digit, dmap_imgsize=dmap_imgsize,
            dmap_imgsize_digit=dmap_imgsize_digit,
            dmap_up4_imgsize_digit=dmap_up4_imgsize_digit,
        )


def window_indices(ref_indx: int, t_win_r: int, step: int = 1) -> List[int]:
    """Source-frame indices of the temporal window around ``ref_indx``
    (the symmetric given-poses window of test_KVNet.py:202-212)."""
    return (
        [ref_indx + i * step for i in range(-t_win_r, 0)]
        + [ref_indx + i * step for i in range(1, t_win_r + 1)]
    )


def rel_pose(ext_ref: np.ndarray, ext_src: np.ndarray) -> np.ndarray:
    """ext_src @ inv(ext_ref) (homography.py:904-906)."""
    return (ext_src @ np.linalg.inv(ext_ref)).astype(np.float32)


def window_batch(traj: Trajectory, ref_indx: int, t_win_r: int,
                 step: int = 1, with_labels: bool = False, img_fn=None):
    """Assemble the 1-lane step batch for a reference frame.

    Returns (batch dict, ref FrameRecord, window_valid: bool).
    ``pose_next`` is the relative pose to the next reference frame
    (ref + step), which is what the prediction resample targets
    (test_utils/test_KVNet.py:47-62).

    ``img_fn(rec) -> (H, W, 3) normalized image`` overrides the stored
    image — the augmentation hook (data/augment.make_window_augment); it
    must be deterministic per record so shared frames of overlapping
    windows stay photoconsistent.
    """
    idxs = window_indices(ref_indx, t_win_r, step)
    ref = traj.frame(ref_indx)
    srcs = [traj.frame(i) for i in idxs]
    valid = ref.pose_valid and all(s.pose_valid for s in srcs)

    poses = np.stack([rel_pose(ref.ext_M, s.ext_M) for s in srcs])
    next_idx = min(ref_indx + step, len(traj) - 1)
    pose_next = rel_pose(ref.ext_M, traj.frame(next_idx).ext_M)

    get_img = img_fn or (lambda r: r.img)
    batch = {
        "ref": get_img(ref)[None],
        "srcs": np.stack([get_img(s) for s in srcs])[None],
        "poses": poses[None].astype(np.float32),
        "K": traj.K_dpv[None].astype(np.float32),
        "pose_next": pose_next[None].astype(np.float32),
    }
    if with_labels:
        batch["dmap_digit"] = ref.dmap_digit[None]
        batch["dmap_imgsize_digit"] = ref.dmap_imgsize_digit[None]
        batch["dmap_imgsize"] = ref.dmap_imgsize[None].astype(np.float32)
        batch["lane_valid"] = np.asarray([valid])
        if ref.dmap_up4_imgsize_digit is not None:
            batch["dmap_up4_imgsize_digit"] = ref.dmap_up4_imgsize_digit[None]
    return batch, ref, valid

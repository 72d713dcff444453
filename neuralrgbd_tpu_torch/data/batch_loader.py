"""Trajectory batch scheduler for training.

Reference semantics (``mdataloader/batch_loader.py``): one trajectory per
batch lane (= one device), trajectories partitioned into groups of
``batch_size``; every lane starts at a random frame and all lanes advance
one reference frame per step for a common ``traj_len`` =
min(lane lengths) - 2 * t_win_r (batch_loader.py:175-190); invalid
poses/depths surface as per-lane validity instead of NaN volume surgery.

Copy of ``neuralrgbd_tpu/data/batch_loader.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_standalone.py`` holds it equal to the original.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from neuralrgbd_tpu_torch.data.trajectory import Trajectory, window_batch


class BatchGroup:
    """A group of ``batch_size`` trajectories advanced in lockstep."""

    def __init__(self, lanes: List[Trajectory], t_win_r: int, step: int,
                 rng: np.random.RandomState, augment: bool = False):
        self.lanes = lanes
        self.t_win_r = t_win_r
        self.step = step
        span = 2 * t_win_r * step
        usable = [len(t) - span - 1 for t in lanes]
        self.traj_len = max(0, min(usable))
        # per-lane random start offset so lanes don't sync on scene structure
        self.offsets = [
            int(rng.randint(0, u - self.traj_len + 1)) if u > self.traj_len
            else 0
            for u in usable
        ]
        # one photometric parameter draw per lane per group: stronger than
        # per-window consistency (shared frames of overlapping windows AND
        # the DPV carry all see one appearance), deterministic per seed.
        # A tiny per-lane LRU avoids re-jittering the ~2*t_win_r shared
        # frames of consecutive windows.
        self.img_fns = [None] * len(lanes)
        if augment:
            from neuralrgbd_tpu_torch.data.augment import make_window_augment

            for i in range(len(lanes)):
                self.img_fns[i] = _cached_img_fn(
                    make_window_augment(int(rng.randint(0, 2 ** 31))))

    def frame_batch(self, frame_idx: int):
        """Stacked lanes batch for reference-frame position ``frame_idx``.

        Returns (batch dict incl. labels + lane_valid, ref records)."""
        parts, refs = [], []
        for lane, off, img_fn in zip(self.lanes, self.offsets, self.img_fns):
            ref_indx = self.t_win_r * self.step + off + frame_idx
            b, ref, valid = window_batch(lane, ref_indx, self.t_win_r,
                                         self.step, with_labels=True,
                                         img_fn=img_fn)
            b["lane_valid"] = np.asarray([valid])
            parts.append(b)
            refs.append(ref)
        batch = {
            k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]
        }
        return batch, refs


def _cached_img_fn(fn, capacity: int = 12):
    """Wrap an image fn with a tiny per-record LRU (keyed on the record's
    path, so the sliding window's shared frames jitter once)."""
    from collections import OrderedDict

    cache: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def wrapped(rec):
        key = rec.img_path
        if key not in cache:
            cache[key] = fn(rec)
            while len(cache) > capacity:
                cache.popitem(last=False)
        return cache[key]

    return wrapped


class BatchScheduler:
    """Iterates over groups of trajectories (one epoch)."""

    def __init__(
        self,
        make_traj: Callable[[int], Trajectory],
        n_traj: int,
        batch_size: int,
        t_win_r: int = 2,
        step: int = 1,
        seed: int = 0,
        shuffle: bool = True,
        augment: bool = False,
    ):
        self.make_traj = make_traj
        self.n_traj = n_traj
        self.batch_size = batch_size
        self.t_win_r = t_win_r
        self.step = step
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        order = np.arange(n_traj)
        if shuffle:
            self.rng.shuffle(order)
        # drop the ragged tail so lane count (= mesh lanes) stays static
        n_groups = n_traj // batch_size
        self.groups = [
            order[i * batch_size:(i + 1) * batch_size].tolist()
            for i in range(n_groups)
        ]

    def __len__(self) -> int:
        return len(self.groups)

    def __iter__(self):
        for idxs in self.groups:
            lanes = [self.make_traj(i) for i in idxs]
            yield BatchGroup(lanes, self.t_win_r, self.step, self.rng,
                             augment=self.augment)

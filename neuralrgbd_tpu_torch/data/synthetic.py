"""Synthetic batches (copy of ``neuralrgbd_tpu/data/synthetic.py:
synthetic_batch``): random-texture windows with small known camera motion
at the reference operating point, in the step's batch layout. Held equal
to the original, array for array, by ``tests/test_torch_standalone.py``.
"""

from __future__ import annotations

import numpy as np

from neuralrgbd_tpu_torch.config import ModelConfig


def synthetic_batch(cfg: ModelConfig, n_lanes: int = 1,
                    img_hw=(256, 384), seed: int = 0,
                    baseline: float = 0.04):
    """Returns (batch dict of np arrays, K_dpv) at the given operating point."""
    rng = np.random.RandomState(seed)
    H, W = img_hw
    h, w = H // 4, W // 4
    V = cfg.n_views
    D = cfg.ndepth

    K = np.array(
        [[w / 2 / np.tan(np.radians(30)), 0, w / 2],
         [0, h / 2 / np.tan(np.radians(24)), h / 2],
         [0, 0, 1]],
        np.float32,
    )

    def rand_pose(scale):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.randn(3).astype(np.float32) * scale
        return pose

    batch = {
        "ref": rng.randn(n_lanes, H, W, 3).astype(np.float32),
        "srcs": rng.randn(n_lanes, V, H, W, 3).astype(np.float32),
        "poses": np.stack(
            [np.stack([rand_pose(baseline) for _ in range(V)])
             for _ in range(n_lanes)]
        ),
        "K": np.tile(K, (n_lanes, 1, 1)),
        "pose_next": np.stack([rand_pose(baseline) for _ in range(n_lanes)]),
        "dmap_digit": rng.randint(0, D, size=(n_lanes, h, w)).astype(np.int32),
        "dmap_imgsize_digit": rng.randint(0, D, size=(n_lanes, H, W)).astype(np.int32),
        "dmap_up4_imgsize_digit": rng.randint(
            0, 4 * D, size=(n_lanes, H, W)).astype(np.int32),
        "dmap_imgsize": rng.uniform(cfg.d_min, cfg.d_max,
                                    size=(n_lanes, H, W)).astype(np.float32),
        "lane_valid": np.ones((n_lanes,), bool),
    }
    return batch, K

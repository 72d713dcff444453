"""Counterpart of ``neuralrgbd_tpu/ops/pallas/sweep.py::sweep_cost_volume_pallas``.

The TPU kernel turned the bilinear warp into one-hot matmuls over a BY=16
source-row band, because Mosaic cannot gather; it computes the same
function as the fused sweep. Here it is an entry point with its
preconditions (L2 only, ``keep_last_channels`` in {0, 3}) onto the sweep
kernel of ``ops.cuda.sweep_fused``, which is exact for any pose. Nothing in
the JAX package wires it in; it is kept so that every TPU kernel has a
named counterpart.
"""

from __future__ import annotations

import torch

from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda.sweep_fused import sweep_cost_volume_fused


def sweep_cost_volume_l2(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                         Rs: torch.Tensor, ts: torch.Tensor, cam: Camera,
                         d_candi: torch.Tensor, sigma: float,
                         keep_last_channels: int = 0, *,
                         feat_dist: str = "L2"):
    """Drop-in for ``ops.sweep.sweep_cost_volume`` with L2 distance:
    cost (D, H, W), plus the warped last 3 channels (V, D, H, W, 3) when
    ``keep_last_channels`` is 3. Raises for any other distance or count."""
    if feat_dist != "L2":
        raise ValueError(f"sweep_cost_volume_l2 computes L2 only, got "
                         f"{feat_dist!r}")
    if keep_last_channels not in (0, 3):
        raise ValueError("sweep_cost_volume_l2 keeps the last 3 (intensity) "
                         f"channels or none, got {keep_last_channels}")
    return sweep_cost_volume_fused(ref_feat, src_feats, Rs, ts, cam, d_candi,
                                   sigma, "L2", keep_last_channels)

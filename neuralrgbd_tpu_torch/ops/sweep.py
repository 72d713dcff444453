"""Plane-sweep warps and cost volumes (counterpart of ``neuralrgbd_tpu/ops/sweep.py``).

For a pixel with unit ray ur and depth hypothesis d the source-image
location is p_src ~ K t + (K R ur) d, normalised around the principal point
and sampled bilinearly with zero padding (align_corners=True).

These are the plain PyTorch versions. The main path runs the same function
on a hand-written kernel, ``ops.cuda.sweep_fused``, whose plain twin is
``sweep_cost_volume_from_coords`` below.
"""

from __future__ import annotations

import torch

from neuralrgbd_tpu_torch.ops.camera import Camera, unit_rays
from neuralrgbd_tpu_torch.ops.sampling import grid_sample_2d


def _sweep_pixel_coords(cam: Camera, R: torch.Tensor, t: torch.Tensor,
                        d_candi: torch.Tensor, height: int, width: int):
    """Source-view sample coords for every (depth, pixel).

    R (..., 3, 3), t (..., 3): leading axes (the views) broadcast. Returns
    (..., D, H*W, 2) pixel-unit xy coordinates.
    """
    rays = unit_rays(cam, height, width)                    # (3, HW)
    term1 = cam.K @ t[..., None]                            # (..., 3, 1)
    term2 = cam.K @ R @ rays                                # (..., 3, HW)
    p = term1[..., None, :, :] + term2[..., None, :, :] * d_candi.reshape(
        -1, 1, 1)                                           # (..., D, 3, HW)
    z = p[..., 2, :] + 1e-10
    u = p[..., 0, :] / z
    v = p[..., 1, :] / z
    # align_corners pixel mapping of gx = (u - cx)/cx: px = u * (W-1) / (2 cx)
    px = u * ((width - 1) / 2.0) / cam.cx
    py = v * ((height - 1) / 2.0) / cam.cy
    return torch.stack([px, py], dim=-1)


def warp_to_ref_over_depths(src_imgs: torch.Tensor, Rs: torch.Tensor,
                            ts: torch.Tensor, cam: Camera,
                            d_candi: torch.Tensor) -> torch.Tensor:
    """Warp every source image (V, H, W, C) into the reference view for
    every depth. Returns (V, D, H, W, C)."""
    V, H, W, C = src_imgs.shape
    coords = _sweep_pixel_coords(cam, Rs, ts, d_candi, H, W)  # (V, D, HW, 2)
    warped = grid_sample_2d(src_imgs, coords, padding="zeros")
    return warped.reshape(V, -1, H, W, C)


def sweep_cost_volume_from_coords(ref_feat: torch.Tensor,
                                  src_feats: torch.Tensor,
                                  coords: torch.Tensor, sigma: float,
                                  feat_dist: str = "L2",
                                  keep_last_channels: int = 0):
    """Cost volume from precomputed sample coords (V, D, H*W, 2).

    ref_feat (H, W, C), src_feats (V, H, W, C). Returns cost (D, H, W), or
    (cost, kept (V, D, H, W, k)) when ``keep_last_channels`` = k > 0.
    """
    V, H, W, C = src_feats.shape
    D = coords.shape[1]
    k = keep_last_channels
    warped = grid_sample_2d(src_feats, coords, padding="zeros")  # (V,D,HW,C)
    diff = warped - ref_feat.reshape(1, 1, H * W, C)
    if feat_dist == "L2":
        cost_v = (diff * diff).sum(-1)
    elif feat_dist == "L1":
        cost_v = diff.abs().sum(-1)
    else:
        raise ValueError(f"undefined feature distance: {feat_dist}")
    cost = (cost_v / sigma).sum(0).reshape(D, H, W)
    if not k:
        return cost
    return cost, warped[..., C - k:].reshape(V, D, H, W, k)


def sweep_cost_volume(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                      Rs: torch.Tensor, ts: torch.Tensor, cam: Camera,
                      d_candi: torch.Tensor, sigma: float,
                      feat_dist: str = "L2", keep_last_channels: int = 0):
    """Plane-sweep cost volume summed over source views:
    cost[d, h, w] = sum_views ||warp_d(src)[h, w] - ref[h, w]||_p / sigma.

    Out-of-frustum taps read zeros, so a fully-out pixel contributes the
    bare ||ref|| term, as in the reference. ``keep_last_channels`` = k also
    returns the warped last k channels (the K-Net's warped RGB).
    """
    H, W = ref_feat.shape[:2]
    coords = _sweep_pixel_coords(cam, Rs, ts, d_candi, H, W)
    return sweep_cost_volume_from_coords(ref_feat, src_feats, coords, sigma,
                                         feat_dist, keep_last_channels)


def backward_warp_by_depth(src_imgs: torch.Tensor, dmap: torch.Tensor,
                           Rs: torch.Tensor, ts: torch.Tensor, cam: Camera,
                           sample_method: str | None = None) -> torch.Tensor:
    """Depth-map-based backward warp (``back_warp_th_Rt_msrc``): back-project
    the reference depth map, reproject into each source view, sample.
    Used by the LBA's photometric objective. Returns (V, H, W, C).

    src_imgs (V, H, W, C); dmap (H, W), or (V, H, W) for one depth map per
    view (the LBA's bi-directional term); Rs (V, 3, 3), ts (V, 3) ref->src.
    All views in one batch. As in JAX there is no epsilon on z
    (homography.py:515,561 divides by z directly), and the pixel mapping
    is JAX's ``u * ((W-1)/2) / cx``. ``sample_method``: see
    ``ops.sampling.grid_sample_2d``.
    """
    V, H, W, C = src_imgs.shape
    rays = unit_rays(cam, H, W)                              # (3, HW)
    pts = dmap.reshape(-1, 1, H * W) * rays                  # (1|V, 3, HW)
    p = cam.K @ (Rs @ pts + ts[..., None])                   # (V, 3, HW)
    u = p[:, 0] / p[:, 2]
    v = p[:, 1] / p[:, 2]
    px = u * ((W - 1) / 2.0) / cam.cx
    py = v * ((H - 1) / 2.0) / cam.cy
    coords = torch.stack([px, py], dim=-1)                   # (V, HW, 2)
    return grid_sample_2d(src_imgs, coords, padding="zeros",
                          method=sample_method).reshape(V, H, W, C)

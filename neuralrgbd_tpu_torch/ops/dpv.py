"""Depth Probability Volume algebra (counterpart of ``neuralrgbd_tpu/ops/dpv.py``).

The DPV is a per-pixel categorical distribution over D depth hypotheses,
kept in log scale. ``resample_dpv`` is the Bayesian filter's prediction
step, as the plain path runs it (``F.grid_sample``); the main path runs
the whole prediction step, inverse included, on the hand-written kernel
of ``ops.cuda.resample``.
"""

from __future__ import annotations

import math

import torch

from neuralrgbd_tpu_torch.ops.camera import Camera, unit_rays
from neuralrgbd_tpu_torch.ops.sampling import grid_sample_3d, normalized_to_pixel


def depth_regression(dpv: torch.Tensor, d_candi: torch.Tensor,
                     log_scale: bool = True) -> torch.Tensor:
    """E[d] = sum_d p(d) d over a DPV, log-scale unless ``log_scale`` is
    False (then ``dpv`` holds the probabilities): (..., D, H, W) ->
    (..., H, W)."""
    p = dpv.exp() if log_scale else dpv
    return torch.einsum("...dhw,d->...hw", p, d_candi)


def depth_variance(dpv: torch.Tensor, depth_mean: torch.Tensor,
                   d_candi: torch.Tensor, log_scale: bool = True,
                   d_sigma: float = 1.0) -> torch.Tensor:
    """The reference's depth variance (mutils/misc.py:550-572):
    mean_d (p(d) * d - E[d])^2 / (2 d_sigma^2), with p(d) * d, not d,
    inside the square, as the L1 training loss regularizes it; ``dpv`` is
    log-scale unless ``log_scale`` is False. (..., D, H, W) -> (..., H, W)."""
    p = dpv.exp() if log_scale else dpv
    D = d_candi.shape[0]
    sq = (p * d_candi[:, None, None] - depth_mean[..., None, :, :]) ** 2
    return sq.sum(dim=-3) / (2.0 * d_sigma ** 2) / D


def confidence_map(dpv: torch.Tensor, log_scale: bool = True) -> torch.Tensor:
    """Probability of the argmax depth bin: exp(max_d log-DPV), or max_d
    of the probabilities when ``log_scale`` is False."""
    m = dpv.amax(dim=-3)
    return m.exp() if log_scale else m


def dpv_statistics(dpv: torch.Tensor, d_candi: torch.Tensor,
                   statistics=("E_mean", "variance", "max", "min"),
                   log_scale: bool = True) -> torch.Tensor:
    """Per-pixel DPV feature maps (mutils/misc.py:574-608), stacked in the
    order of ``statistics``: E[d], the depth variance, and the max and min
    of the probabilities. (..., D, H, W) -> (..., len(statistics), H, W)."""
    p = dpv.exp() if log_scale else dpv
    feats, mean = [], None
    for name in statistics:
        if name in ("E_mean", "variance") and mean is None:
            mean = depth_regression(dpv, d_candi, log_scale)
        if name == "E_mean":
            feats.append(mean)
        elif name == "variance":
            feats.append(depth_variance(dpv, mean, d_candi,
                                        log_scale=log_scale))
        elif name == "max":
            feats.append(p.amax(dim=-3))
        elif name == "min":
            feats.append(p.amin(dim=-3))
        else:
            raise ValueError(f"unknown dpv statistic: {name}")
    return torch.stack(feats, dim=-3)


def _set_vol_border(vol: torch.Tensor, border_val: float) -> torch.Tensor:
    """Set all six faces of a (D, H, W) volume to ``border_val``: with border
    padding, out-of-frustum samples then decay toward the uniform prior."""
    out = vol.clone()
    out[[0, -1]] = border_val
    out[:, [0, -1]] = border_val
    out[:, :, [0, -1]] = border_val
    return out


def resample_coords(cam: Camera, rel_Rt: torch.Tensor, d_candi: torch.Tensor,
                    H: int, W: int):
    """Pixel-space sample coords (cx, cy, cz), each (D, H*W), of the DPV
    resample: back-project d * ray, apply ``rel_Rt``, map x and y by the fov
    tangents and z by the depth range."""
    D = d_candi.shape[0]
    rays = unit_rays(cam, H, W)                              # (3, HW)
    pts = rays[None] * d_candi.reshape(-1, 1, 1)             # (D, 3, HW)
    R = rel_Rt[:3, :3]
    t = rel_Rt[:3, 3]
    p = torch.einsum("ij,djn->din", R, pts) + t.reshape(1, 3, 1)
    z = p[:, 2] + 1e-10
    z_max = d_candi.max()
    z_min = d_candi.min()
    z_mid = (z_max + z_min) * 0.5
    z_rad = (z_max - z_min) * 0.5
    gx = p[:, 0] / z / cam.tan_half_hfov
    gy = p[:, 1] / z / cam.tan_half_vfov
    gz = (p[:, 2] - z_mid) / z_rad
    return (normalized_to_pixel(gx, W), normalized_to_pixel(gy, H),
            normalized_to_pixel(gz, D))


def resample_from_coords(dpv: torch.Tensor, cx: torch.Tensor,
                         cy: torch.Tensor, cz: torch.Tensor,
                         padding_value: float,
                         clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """Trilinear border-padded sample of ``dpv`` (D, H, W) at (cx, cy, cz)
    after writing ``padding_value`` on its faces, then the clamp."""
    D, H, W = dpv.shape
    vol = _set_vol_border(dpv, padding_value)
    out = grid_sample_3d(vol, torch.stack([cx, cy, cz], dim=-1),
                         padding="border").reshape(D, H, W)
    if clamp_to is not None:
        out = out.clamp(clamp_to[0], clamp_to[1])
    return out


def resample_dpv(dpv: torch.Tensor, rel_Rt: torch.Tensor, cam: Camera,
                 d_candi: torch.Tensor, padding_value: float,
                 clamp_to=(-1000.0, 0.0)) -> torch.Tensor:
    """Prediction step: resample the log-DPV (D, H, W) of the current view
    into the frustum of the view ``rel_Rt`` (4, 4) maps to."""
    D, H, W = dpv.shape
    cx, cy, cz = resample_coords(cam, rel_Rt, d_candi, H, W)
    return resample_from_coords(dpv, cx, cy, cz, padding_value, clamp_to)


def uniform_dpv(D: int, H: int, W: int, device=None) -> torch.Tensor:
    """log(1/D) everywhere: the no-information DPV that starts the filter."""
    return torch.full((D, H, W), -math.log(D), dtype=torch.float32,
                      device=device)

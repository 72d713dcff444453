"""Differentiable guided filter and the DGF refinement head (counterpart of
``neuralrgbd_tpu/models/guided_filter.py``).

Reference: ``models/GF/{box_filter,guided_filter}.py`` and
``RefineNet_DGF`` (Refine.py:587-641), the head ``refine_net='DGF'``
selects (KVNET.py:80-81). The box filter is the reference's cumulative-sum
formula, not ``F.avg_pool2d``: its windows shrink at the borders and ``N``
(the box sum of ones) normalises them. Tensors are (..., H, W); the guided
filter's closed-form (A, b) solve is elementwise over the leading axes.

Conditioning: ``A = cov_xy / (var_x + eps)`` with ``var_x = E[x^2] -
E[x]^2`` cancels where the guide is flat, so two programs that sum in
another order differ there by up to 1/var_x times their rounding; the
tests hold the head in float64.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuralrgbd_tpu_torch.models.layers import Conv2d, upsample_bilinear_ac


def box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the (2r+1)^2 window around each pixel, clipped at the
    borders, by cumsum and slicing. x: (..., H, W)."""
    H, W = x.shape[-2:]
    if not (H > 2 * r + 1 and W > 2 * r + 1):
        raise ValueError(f"radius {r} too large for a {H}x{W} image")

    def along(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        c = torch.cumsum(x, dim=dim)
        left = c.narrow(dim, r, r + 1)
        mid = (c.narrow(dim, 2 * r + 1, size - 2 * r - 1)
               - c.narrow(dim, 0, size - 2 * r - 1))
        right = c.narrow(dim, size - 1, 1) - c.narrow(dim, size - 2 * r - 1, r)
        return torch.cat([left, mid, right], dim=dim)

    return along(along(x, -2, H), -1, W)


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    """(..., h, w) -> (..., H, W), bilinear on the align_corners grid."""
    lead = x.shape[:-2]
    y = upsample_bilinear_ac(x.reshape(-1, 1, *x.shape[-2:]), hw)
    return y.reshape(*lead, *y.shape[-2:])


def _solve(guide: torch.Tensor, src: torch.Tensor, r: int, eps: float):
    """The guided filter's per-pixel linear model src ~ A * guide + b."""
    N = box_filter(torch.ones_like(guide), r)
    mean_x = box_filter(guide, r) / N
    mean_y = box_filter(src, r) / N
    cov_xy = box_filter(guide * src, r) / N - mean_x * mean_y
    var_x = box_filter(guide * guide, r) / N - mean_x * mean_x
    A = cov_xy / (var_x + eps)
    return A, mean_y - A * mean_x, N


class GuidedFilter:
    """Closed-form guided filter (guided_filter.py:54-97): guide and src
    (..., H, W) -> (..., H, W)."""

    def __init__(self, r: int, eps: float = 1e-8):
        self.r = r
        self.eps = eps

    def __call__(self, guide: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        A, b, N = _solve(guide, src, self.r, self.eps)
        mean_A = box_filter(A, self.r) / N
        mean_b = box_filter(b, self.r) / N
        return mean_A * guide + mean_b


class FastGuidedFilter:
    """The (A, b) solve at low resolution, upsampled to the full-resolution
    guide (guided_filter.py:13-51): (..., h, w) twice and (..., H, W)."""

    def __init__(self, r: int, eps: float = 1e-8):
        self.r = r
        self.eps = eps

    def __call__(self, guide_lr: torch.Tensor, src_lr: torch.Tensor,
                 guide_hr: torch.Tensor) -> torch.Tensor:
        A, b, _ = _solve(guide_lr, src_lr, self.r, self.eps)
        hw = guide_hr.shape[-2:]
        return _upsample(A, hw) * guide_hr + _upsample(b, hw)


class RefineNetDGF(nn.Module):
    """The deep-guided-filter head (``RefineNet_DGF``, Refine.py:587-641):
    the low-res depth map upsampled bilinearly (align_corners), a
    one-channel guide from the RGB frame by ``feature_ext`` =
    Conv2d(3, 64, 1) + ReLU + Conv2d(64, 1, 1) (state_dict keys
    ``feature_ext.0.*`` and ``feature_ext.2.*``, Refine.py:598-601), then
    the full-resolution ``GuidedFilter(r=1, eps=1e-8)``."""

    def __init__(self, r: int = 1, eps: float = 1e-8, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.gf = GuidedFilter(r, eps)
        self.feature_ext = nn.Sequential(
            Conv2d(3, 64, 1, 1, padding=0, bias=True, device=device,
                   compute_dtype=compute_dtype),
            nn.ReLU(),
            Conv2d(64, 1, 1, 1, padding=0, bias=True, device=device,
                   compute_dtype=compute_dtype))

    def forward(self, dmap_lowres: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
        """dmap_lowres (N, h, w) depth; img (N, 3, H, W) the normalised
        RGB guide -> (N, H, W) depth."""
        guide = self.feature_ext(img)[:, 0]
        return self.gf(guide, _upsample(dmap_lowres, img.shape[-2:]))

"""K-Net: the 3-D CNN that approximates the Kalman gain (counterpart of
``neuralrgbd_tpu/models/knet.py``; the reference's ``KV_NET_BASIC``).

A residual stack of five convbn_3d pairs plus a one-channel classify head.
Input (N, C_in, D, H, W); returns the gain volume (N, D', H, W).
``up_sample_ratio`` is the reference's optional trilinear D-upsample of the
gain (``basic.py:128-139``): H and W keep their size, so with
align_corners=True it is a 1-D linear interpolation along D, one
(ratio*D, D) matrix applied in fp32, and D' = ratio*D. ``compute_dtype``:
the convs' dtype (``models/layers.py``), None for fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuralrgbd_tpu_torch.models.layers import (Conv3d, convbn_3d, kernel_path,
                                                linear_interp_matrix_ac)
from neuralrgbd_tpu_torch.ops.cuda import conv3d_f32 as k3


class KNet(nn.Module):
    def __init__(self, in_channels: int, feature_dim: int = 64, device=None,
                 up_sample_ratio: Optional[int] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        f, dt = feature_dim, compute_dtype
        self.up_sample_ratio = up_sample_ratio
        self.compute_dtype = compute_dtype
        self.dres0 = nn.Sequential(
            convbn_3d(in_channels, f, 3, 1, 1, device, dt),
            nn.ReLU(inplace=True),
            convbn_3d(f, f, 3, 1, 1, device, dt), nn.ReLU(inplace=True))
        for i in range(1, 5):
            self.add_module(f"dres{i}", nn.Sequential(
                convbn_3d(f, f, 3, 1, 1, device, dt), nn.ReLU(inplace=True),
                convbn_3d(f, f, 3, 1, 1, device, dt)))
        self.classify = nn.Sequential(
            convbn_3d(f, f, 3, 1, 1, device, dt), nn.ReLU(inplace=True),
            Conv3d(f, 1, 3, 1, padding=1, bias=False, device=device,
                   compute_dtype=dt))

    def forward(self, vol: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if kernel_path(kernels, vol.is_cuda, vol.dtype, self.compute_dtype,
                       torch.is_grad_enabled()):
            out = self.fused(vol)
        else:
            cost = self.dres0(vol)
            for i in range(1, 5):
                cost = getattr(self, f"dres{i}")(cost) + cost
            out = self.classify(cost)[:, 0]
        if self.up_sample_ratio is not None:
            D = out.shape[1]
            m = linear_interp_matrix_ac(D, self.up_sample_ratio * D)
            out = torch.einsum("od,ndhw->nohw", m.to(out.device), out.float())
        return out

    def fused(self, vol: torch.Tensor) -> torch.Tensor:
        """The convs (and their BatchNorms, ReLUs and residual adds) on the
        conv kernels (their plain twins for CPU tensors), one volume (1,
        C_in, D, H, W): each activation is split once for its readers, a
        residual block's output written once as BN(conv) + skip; the last
        conv (64 -> 1) on the head kernel, the BatchNorm and ReLU before it
        applied as it loads. Returns (1, D, H, W). A batch of volumes
        raises: BatchNorm's statistics are the batch's, so volume by volume
        would be another result."""
        if vol.dim() != 5 or vol.shape[0] != 1:
            raise ValueError(f"KNet.fused takes one volume (1, C_in, D, H, "
                             f"W), got {tuple(vol.shape)}")

        def conv(s, layer, relu):
            return k3.conv_bn(s, layer[0], layer[1], relu)

        x = vol[0].permute(1, 2, 3, 0)                 # (D, H, W, C_in)
        a = conv(k3.split(k3.Act(x)), self.dres0[0], relu=True)
        cost = k3.split(conv(k3.split(a), self.dres0[2], relu=True))
        for i in range(1, 5):
            block = getattr(self, f"dres{i}")
            a = conv(cost, block[0], relu=True)
            a = conv(k3.split(a), block[2], relu=False)
            cost = k3.split(a._replace(skip=cost))
        return k3.head(conv(cost, self.classify[0], relu=True),
                       self.classify[2])[None]

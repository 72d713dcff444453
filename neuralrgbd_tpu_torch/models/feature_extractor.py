"""PSMNet-style spatial-pyramid feature extractor, the D-Net backbone
(counterpart of ``neuralrgbd_tpu/models/feature_extractor.py``).

Module names follow the reference's ``psm_submodule.feature_extraction``, so
its state_dict keys are the reference's. As there: layer3 has dilation 1,
layer4 dilation 2, and the residual blocks have no ReLU after the add.

Input (B, 3, H, W). Returns (layer1 (B, 32, H/2, W/2),
feat (B, feature_dim, H/4, W/4)). ``compute_dtype``: the convs' dtype
(``models/layers.py``), None for fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralrgbd_tpu_torch.models.layers import (Conv2d, convbn,
                                                upsample_bilinear_ac)

POOLS = (64, 32, 16, 8)   # branch1..branch4


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, dilation: int,
                 downsample: bool, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = nn.Sequential(
            convbn(inplanes, planes, 3, stride, 1, dilation, device,
                   compute_dtype),
            nn.ReLU(inplace=True))
        self.conv2 = convbn(planes, planes, 3, 1, 1, dilation, device,
                            compute_dtype)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes, 1, stride, bias=False, device=device,
                   compute_dtype=compute_dtype),
            nn.BatchNorm2d(planes, track_running_stats=False, device=device),
        ) if downsample else None

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def _layer(inplanes, planes, blocks, stride, dilation, device, dt):
    down = stride != 1 or inplanes != planes
    return nn.Sequential(
        BasicBlock(inplanes, planes, stride, dilation, down, device, dt),
        *(BasicBlock(planes, planes, 1, dilation, False, device, dt)
          for _ in range(1, blocks)))


class FeatureExtractor(nn.Module):
    def __init__(self, feature_dim: int = 64, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dt = compute_dtype
        self.firstconv = nn.Sequential(
            convbn(3, 32, 3, 2, 1, 1, device, dt), nn.ReLU(inplace=True),
            convbn(32, 32, 3, 1, 1, 1, device, dt), nn.ReLU(inplace=True),
            convbn(32, 32, 3, 1, 1, 1, device, dt), nn.ReLU(inplace=True))
        self.layer1 = _layer(32, 32, 3, 1, 1, device, dt)
        self.layer2 = _layer(32, 64, 16, 2, 1, device, dt)
        self.layer3 = _layer(64, 128, 3, 1, 1, device, dt)
        self.layer4 = _layer(128, 128, 3, 1, 2, device, dt)
        for i, pool in enumerate(POOLS):
            # index 0 is the reference's fixed AvgPool2d; forward clamps the
            # window to the feature map (see below) and runs [1:] itself
            self.add_module(f"branch{i + 1}", nn.Sequential(
                nn.AvgPool2d(pool, pool),
                convbn(128, 32, 1, 1, 0, 1, device, dt),
                nn.ReLU(inplace=True)))
        self.lastconv = nn.Sequential(
            convbn(320, 128, 3, 1, 1, 1, device, dt), nn.ReLU(inplace=True),
            Conv2d(128, feature_dim, 1, 1, padding=0, bias=False,
                   device=device, compute_dtype=dt))

    def forward(self, x: torch.Tensor):
        y = self.firstconv(x)
        layer1 = self.layer1(y)                     # H/2, 32 ch
        raw = self.layer2(layer1)                   # H/4, 64 ch
        skip = self.layer4(self.layer3(raw))        # H/4, 128 ch
        H, W = skip.shape[-2:]
        branches = []
        for i, pool in enumerate(POOLS):
            # the reference's pool sizes assume >= 64 px feature maps; clamp
            # so small inputs degrade to global pooling (exact at 96x64)
            pool = min(pool, H, W)
            b = getattr(self, f"branch{i + 1}")[1:](F.avg_pool2d(skip, pool))
            branches.append(upsample_bilinear_ac(b, (H, W)))
        # concat order: raw, skip, branch4 (8), branch3, branch2, branch1 (64)
        feat = torch.cat([raw, skip, *branches[::-1]], dim=1)   # 320 ch
        return layer1, self.lastconv(feat)

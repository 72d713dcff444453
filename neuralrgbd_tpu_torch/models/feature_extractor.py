"""PSMNet-style spatial-pyramid feature extractor, the D-Net backbone
(counterpart of ``neuralrgbd_tpu/models/feature_extractor.py``).

Module names follow the reference's ``psm_submodule.feature_extraction``, so
its state_dict keys are the reference's. As there: layer3 has dilation 1,
layer4 dilation 2, and the residual blocks have no ReLU after the add.

Input (B, 3, H, W). Returns (layer1 (B, 32, H/2, W/2),
feat (B, feature_dim, H/4, W/4)). ``compute_dtype``: the convs' dtype
(``models/layers.py``), None for fp32.

``forward(x, kernels=True)`` runs the trunk's convs and their BatchNorms
on the fp32 conv kernel (``ops.cuda.conv2d_bn``) where the call is
inference in fp32 on the card: x a CUDA float32 tensor, ``compute_dtype``
None and grad off. Every other call (training under autograd, a bf16
``compute_dtype``, CPU tensors, ``kernels=False``) runs the modules. The
kernel path leaves the spatial pyramid's pools, its 1x1 convs on the
pooled maps, the upsampling and the concatenation on the modules.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralrgbd_tpu_torch.models.layers import (Conv2d, convbn, kernel_path,
                                                upsample_bilinear_ac)
from neuralrgbd_tpu_torch.ops.cuda import conv2d_bn as kconv

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

    def fused(self, a: kconv.Act) -> torch.Tensor:
        """``forward`` on the conv kernel (its twins for CPU tensors), the
        input an ``Act`` whose pending BatchNorm and ReLU both readers
        apply; the block's output is written once."""
        c1, c2 = self.conv1[0], self.conv2
        y = kconv.conv_bn(a, c1[0], c1[1], relu=True)
        y = kconv.conv_bn(y, c2[0], c2[1])
        if self.downsample is not None:
            a = kconv.conv_bn(a, self.downsample[0], self.downsample[1])
        return kconv.residual(y, a)


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
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, kernels: bool = True):
        if kernel_path(kernels, x.is_cuda, x.dtype, self.compute_dtype,
                       torch.is_grad_enabled()):
            return self.fused(x)
        y = self.firstconv(x)
        layer1 = self.layer1(y)                     # H/2, 32 ch
        raw = self.layer2(layer1)                   # H/4, 64 ch
        skip = self.layer4(self.layer3(raw))        # H/4, 128 ch
        return layer1, self.lastconv(self.pyramid(raw, skip))

    def fused(self, x: torch.Tensor):
        """``forward`` with the trunk's convs and BatchNorms on the conv
        kernel (its plain twins for CPU tensors); the spatial pyramid on
        the modules."""
        a = kconv.Act(x.contiguous())
        for i in (0, 2, 4):
            c = self.firstconv[i]
            a = kconv.conv_bn(a, c[0], c[1], relu=True)
        for block in self.layer1:
            a = kconv.Act(block.fused(a))
        layer1 = a.raw                              # H/2, 32 ch
        for block in self.layer2:
            a = kconv.Act(block.fused(a))
        raw = a.raw                                 # H/4, 64 ch
        for block in (*self.layer3, *self.layer4):
            a = kconv.Act(block.fused(a))
        feat = self.pyramid(raw, a.raw)
        c = self.lastconv[0]
        y = kconv.conv_bn(kconv.Act(feat), c[0], c[1], relu=True)
        return layer1, kconv.conv_bn(y, self.lastconv[2], None).raw

    def pyramid(self, raw: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """The spatial pyramid on ``skip``, concatenated with ``raw`` and
        ``skip``: the 320 channels ``lastconv`` reads."""
        H, W = skip.shape[-2:]
        branches = []
        for i, pool in enumerate(POOLS):
            # the reference's pool sizes assume >= 64 px feature maps; clamp
            # so small inputs degrade to global pooling (exact at 96x64)
            pool = min(pool, H, W)
            b = getattr(self, f"branch{i + 1}")[1:](F.avg_pool2d(skip, pool))
            branches.append(upsample_bilinear_ac(b, (H, W)))
        # concat order: raw, skip, branch4 (8), branch3, branch2, branch1 (64)
        return torch.cat([raw, skip, *branches[::-1]], dim=1)   # 320 ch

"""The legacy refinement heads (counterpart of
``neuralrgbd_tpu/models/refine_legacy.py``; reference: models/Refine.py:135-585).

Four standalone refinement networks the reference ships but never wires
into KVNET (its ``refineNet_name`` dispatches only 'DPV' and 'DGF',
KVNET.py:80-85); neither JAX nor the port wires them either:

- ``RefineNetUnet2D``  (Refine.py:135-214): a 2-D U-Net refining DPV
  statistics and RGB into a full-resolution depth map.
- ``RefineNetDeMoN``   (Refine.py:216-286): DeMoN's refinement block on a
  low-res depth map and RGB; the same trunk after one input conv.
- ``RefineNet3D``      (Refine.py:288-395): a 3-D encoder-decoder with
  residual skips on a (D, H, W) volume; deconv or nearest upsampling.
- ``RefineNetUNet3D``  (Refine.py:397-490 'UNet_Res' at ``res=True``,
  :491-585 'UNet' at ``res=False``): a 3-D U-Net with concatenated skips;
  the Res variant adds the input volume to its output, the plain one has
  a bias in every conv and ends in a ReLU.

Layouts are the port's: images (N, C, H, W), volumes (N, C, D, H, W).
Module names give the reference heads' bare state_dict keys, which
``utils/torch_import.build_refine_head_map`` maps onto JAX's flax paths.
BatchNorm normalises with the batch statistics, in inference too. The 3-D
heads need D, H and W divisible by 4.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuralrgbd_tpu_torch.models.layers import (BatchNorm3d, Conv2d, Conv3d,
                                                ConvTranspose2d,
                                                ConvTranspose3d, convbn_3d,
                                                upsample_bilinear_ac,
                                                upsample_nearest_3d)


def _conv_lrelu(c_in: int, c_out: int, stride: int, device, dt):
    return nn.Sequential(Conv2d(c_in, c_out, 3, stride, padding=1, bias=True,
                                device=device, compute_dtype=dt),
                         nn.LeakyReLU())


def _deconv_lrelu(c_in: int, c_out: int, device, dt):
    return nn.Sequential(ConvTranspose2d(c_in, c_out, 4, 2, padding=1,
                                         bias=True, device=device,
                                         compute_dtype=dt),
                         nn.LeakyReLU())


class _UNet2D(nn.Module):
    """The trunk Unet2D and DeMoN share after their input convs:
    32 -> 64 (stride 2) -> 128 (stride 2) -> transposed convs with
    concatenated skips -> 1 channel. The reference registers it at the
    head's top level, so its keys are bare (``conv1.0.weight``)."""

    def __init__(self, device, dt):
        super().__init__()
        self.conv1 = _conv_lrelu(32, 64, 2, device, dt)
        self.conv1_1 = _conv_lrelu(64, 64, 1, device, dt)
        self.conv2 = _conv_lrelu(64, 128, 2, device, dt)
        self.conv2_1 = _conv_lrelu(128, 128, 1, device, dt)
        self.trans_conv0 = _deconv_lrelu(128, 64, device, dt)
        self.trans_conv1 = _deconv_lrelu(128, 32, device, dt)
        self.conv3 = _conv_lrelu(64, 16, 1, device, dt)
        self.conv3_1 = Conv2d(16, 1, 3, 1, padding=1, bias=True,
                              device=device, compute_dtype=dt)

    def trunk(self, conv0_out: torch.Tensor,
              deep_in: torch.Tensor) -> torch.Tensor:
        conv1_1 = self.conv1_1(self.conv1(deep_in))
        up0 = self.trans_conv0(self.conv2_1(self.conv2(conv1_1)))
        up1 = self.trans_conv1(torch.cat([up0, conv1_1], 1))
        return self.conv3_1(self.conv3(torch.cat([up1, conv0_out], 1)))


class RefineNetUnet2D(_UNet2D):
    """Refine.py:135-214. forward(dpv_stats (N, S, h, w), img (N, 3, H, W))
    -> (N, 1, H, W) refined depth; ``in_channels`` = 3 + S."""

    def __init__(self, in_channels: int, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(device, compute_dtype)
        self.conv0 = _conv_lrelu(in_channels, 32, 1, device, compute_dtype)
        self.conv0_1 = _conv_lrelu(32, 32, 1, device, compute_dtype)

    def forward(self, dpv_stats_lowres: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
        up = upsample_bilinear_ac(dpv_stats_lowres, img.shape[-2:])
        conv0_out = self.conv0(torch.cat([img, up], 1))
        return self.trunk(conv0_out, self.conv0_1(conv0_out))


class RefineNetDeMoN(_UNet2D):
    """Refine.py:216-286. forward(dmap (N, 1, h, w), img (N, img_ch, H, W))
    -> (N, 1, H, W): Unet2D's trunk after a single input conv."""

    def __init__(self, img_ch: int = 3, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(device, compute_dtype)
        self.conv0 = _conv_lrelu(img_ch + 1, 32, 1, device, compute_dtype)

    def forward(self, dmap_lowres: torch.Tensor,
                img: torch.Tensor) -> torch.Tensor:
        up = upsample_bilinear_ac(dmap_lowres, img.shape[-2:])
        conv0_out = self.conv0(torch.cat([img, up], 1))
        return self.trunk(conv0_out, conv0_out)


def _cbr(c_in: int, c_out: int, stride: int, device, dt,
         bias: bool = False) -> nn.Sequential:
    """Sequential(convbn_3d, ReLU): keys ``<name>.0.0.*`` and ``.0.1.*``."""
    return nn.Sequential(convbn_3d(c_in, c_out, 3, stride, 1, device, dt,
                                   bias=bias), nn.ReLU())


class RefineNet3D(nn.Module):
    """Refine.py:288-395. forward(vol (N, C1, D, H, W), img_vol (N, C2, D,
    H, W)), C1 + C2 = ``in_channels`` -> (N, 1, D, H, W)."""

    def __init__(self, in_channels: int, deconv_upsample: bool = True,
                 device=None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, dt = in_channels, compute_dtype
        self.conv1 = _cbr(c, 2 * c, 2, device, dt)
        self.conv2 = _cbr(2 * c, 2 * c, 1, device, dt)
        self.conv3 = _cbr(2 * c, 2 * c, 2, device, dt)
        self.conv4 = _cbr(2 * c, 2 * c, 1, device, dt)
        for name, c_in, c_out in (("conv5", 2 * c, 2 * c),
                                  ("conv6", 2 * c, c)):
            if deconv_upsample:      # Sequential(ConvTranspose3d, BN)
                up = nn.Sequential(
                    ConvTranspose3d(c_in, c_out, 3, 2, padding=1,
                                    output_padding=1, bias=False,
                                    device=device, compute_dtype=dt),
                    BatchNorm3d(c_out, device=device))
            else:                    # Sequential(Upsample, convbn_3d)
                up = nn.Sequential(
                    nn.Upsample(scale_factor=2, mode="nearest"),
                    convbn_3d(c_in, c_out, 3, 1, 1, device, dt))
            self.add_module(name, up)
        self.classif1 = nn.Sequential(
            convbn_3d(c, c, 3, 1, 1, device, dt), nn.ReLU(),
            Conv3d(c, 1, 3, 1, padding=1, bias=False, device=device,
                   compute_dtype=dt))

    def forward(self, vol: torch.Tensor,
                img_vol: torch.Tensor) -> torch.Tensor:
        dw1_r = self.conv2(self.conv1(torch.cat([vol, img_vol], 1)))
        dw2_r = self.conv4(self.conv3(dw1_r))
        up1 = torch.relu(self.conv5(dw2_r) + dw1_r)
        # the skip adds the C1-channel volume to all in_channels channels
        up1_r = torch.relu(self.conv6(up1) + vol)
        return self.classif1(up1_r)


class RefineNetUNet3D(nn.Module):
    """Refine.py:397-490 (``res=True``, 'UNet_Res': convbn without bias,
    the input volume added to the output) and :491-585 (``res=False``,
    'UNet': convbn with bias, a final ReLU inside the head). A 3-D U-Net
    with concatenated skips and nearest upsampling; forward(vol (N, C1, D,
    H, W), img_vol (N, C2, D, H, W)) -> (N, 1, D, H, W)."""

    def __init__(self, in_channels: int, res: bool = True, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        c, dt, bias = in_channels, compute_dtype, not res
        self.res = res
        for name, c_in, c_out, stride in (
                ("conv1", c, 2 * c, 2), ("conv2", 2 * c, 2 * c, 1),
                ("conv3", 2 * c, 4 * c, 2), ("conv4", 4 * c, 4 * c, 1),
                ("conv5", 6 * c, 2 * c, 1), ("conv5_r", 2 * c, 2 * c, 1),
                ("conv6", 3 * c, c, 1), ("conv6_r", c, c, 1)):
            self.add_module(name, _cbr(c_in, c_out, stride, device, dt, bias))
        self.conv7 = nn.Sequential(convbn_3d(c, 1, 3, 1, 1, device, dt,
                                             bias=bias))

    def forward(self, vol: torch.Tensor,
                img_vol: torch.Tensor) -> torch.Tensor:
        x = torch.cat([vol, img_vol], 1)
        dw1_r = self.conv2(self.conv1(x))
        dw2_r = self.conv4(self.conv3(dw1_r))
        up1 = self.conv5(torch.cat([upsample_nearest_3d(dw2_r), dw1_r], 1))
        up2 = self.conv6(torch.cat([upsample_nearest_3d(self.conv5_r(up1)),
                                    x], 1))
        out = self.conv7(self.conv6_r(up2))
        return torch.relu(out + vol if self.res else out)

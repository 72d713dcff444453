"""R-Net: DPV refinement and 4x upsampling head (counterpart of
``neuralrgbd_tpu/models/rnet.py``; the reference's
``RefineNet_DPV_upsample``, Refine.py:24-132).

Treats the D axis of exp(DPV) as channels and upsamples twice by 2x,
concatenating image features at each scale and the RGB guide at full
resolution, ending in a log-softmax over D. With ``upsample_D`` (the
``refine_dup`` head, Refine.py:44-49) each transposed conv also doubles the
depth channels, D0 = 2D and D1 = 4D, and every later conv widens with
them: the refined DPV has 4D bins. The state_dict keys are the same
either way; only the shapes change. ``compute_dtype``: the convs' dtype
(``models/layers.py``), None for fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralrgbd_tpu_torch.models.layers import Conv2d, ConvTranspose2d


def _conv_lrelu(c_in: int, c_out: int, device, dt) -> nn.Sequential:
    return nn.Sequential(Conv2d(c_in, c_out, 3, 1, padding=1, bias=True,
                                device=device, compute_dtype=dt),
                         nn.LeakyReLU())


def _deconv_lrelu(c_in: int, c_out: int, device, dt) -> nn.Sequential:
    return nn.Sequential(ConvTranspose2d(c_in, c_out, 4, 2, padding=1,
                                         bias=True, device=device,
                                         compute_dtype=dt),
                         nn.LeakyReLU())


class RNet(nn.Module):
    """C0/C1/C2 = feature channels at 1/4, 1/2, 1/1 resolution."""

    def __init__(self, D: int = 64, C0: int = 64, C1: int = 32, C2: int = 3,
                 device=None, compute_dtype: Optional[torch.dtype] = None,
                 upsample_D: bool = False):
        super().__init__()
        D0 = 2 * D if upsample_D else D
        D1 = 2 * D0 if upsample_D else D
        c0, c1, c2, dt = D + C0, D0 + C1, D1 + C2, compute_dtype
        self.conv0 = _conv_lrelu(c0, c0, device, dt)
        self.conv0_1 = _conv_lrelu(c0, c0, device, dt)
        self.trans_conv0 = _deconv_lrelu(c0, D0, device, dt)
        self.conv1 = _conv_lrelu(c1, c1, device, dt)
        self.conv1_1 = _conv_lrelu(c1, c1, device, dt)
        self.trans_conv1 = _deconv_lrelu(c1, D1, device, dt)
        self.conv2 = _conv_lrelu(c2, c2, device, dt)
        self.conv2_1 = _conv_lrelu(c2, D1, device, dt)
        self.conv2_2 = Conv2d(D1, D1, 3, 1, padding=1, bias=True,
                              device=device, compute_dtype=dt)

    def forward(self, dpv_prob, feat_quarter, feat_half, img_full):
        """(N, D, h, w), (N, C0, h, w), (N, C1, 2h, 2w), (N, C2, 4h, 4w)
        -> log-DPV (N, D', 4h, 4w), D' = 4D with ``upsample_D``, else D."""
        x = torch.cat([dpv_prob, feat_quarter], dim=1)
        x = self.trans_conv0(self.conv0_1(self.conv0(x)))
        x = torch.cat([x, feat_half], dim=1)
        x = self.trans_conv1(self.conv1_1(self.conv1(x)))
        x = torch.cat([x, img_full], dim=1)
        x = self.conv2_2(self.conv2_1(self.conv2(x)))
        return F.log_softmax(x, dim=1)

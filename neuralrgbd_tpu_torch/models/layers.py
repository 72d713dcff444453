"""Building blocks shared by the D/K/R networks (counterpart of
``neuralrgbd_tpu/models/layers.py``).

Internally the port is NCHW / NCDHW, the PyTorch habit. Parity notes:

- BatchNorm always normalises with the batch statistics (biased variance,
  eps 1e-5), as the reference's ``track_running_stats=False`` BN does at
  train and eval time: ``nn.BatchNorm*d(track_running_stats=False)``.
  ``BatchNorm2d`` also takes one value per channel, as JAX's BatchNorm
  does (a pooled 1x1 map of one frame, with B=1 statistics).
- Convolutions take torch's explicit symmetric padding, which is what the
  JAX layers reproduce; ``ConvTranspose2d(k=4, s=2, p=1)`` is torch's own
  (the JAX kernel is its spatial flip, see ``utils/torch_import.py``).
- ``F.avg_pool2d(x, k)`` (VALID, floor) and ``F.leaky_relu`` (slope 0.01)
  are the JAX ``avg_pool2d`` and ``leaky_relu`` as they are.
- The initialisers are the reference's: fan-out He normal for convs,
  BN scale 1 and bias 0, bilinear kernels for transposed convs.
- ``compute_dtype`` (``cfg.dtype`` other than float32) is the JAX layers'
  ``dtype`` (``neuralrgbd_tpu/models/layers.py:78-199``): the conv's input
  and weight are cast to it, the bias is added in it as a second rounding,
  and the result is cast back to the input's dtype. BatchNorm and
  everything between convs stay fp32. ``Conv2d``, ``Conv3d`` and
  ``ConvTranspose2d`` are ``nn.Conv*d`` with that one attribute, so their
  state_dict keys are torch's.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _cast(module: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``module.<name>`` cast to ``dtype``, cast once and kept on the module
    until the parameter is written in place (its version moves) or
    replaced. Where autograd needs the parameter, cast on every call."""
    p = getattr(module, name)
    if torch.is_grad_enabled() and p.requires_grad:
        return p.to(dtype)
    key = (p.data_ptr(), p._version, dtype)
    cache = module.__dict__.setdefault("_casts", {})
    hit = cache.get(name)
    if hit is None or hit[0] != key:
        hit = cache[name] = (key, p.detach().to(dtype))
    return hit[1]


class _ComputeDtype:
    """The JAX layers' conv ``dtype`` on an ``nn.Conv*d`` (module docstring);
    ``compute_dtype=None`` is the plain fp32 module."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, w, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None or dt == x.dtype:
            return super().forward(x)
        # the bias goes in after the conv's own rounding, as JAX's
        # ``y + b.astype(dtype)``: F.conv*d(x, w, b) would fuse it before
        y = self._conv(x.to(dt), _cast(self, "weight", dt))
        if self.bias is not None:
            y = y + _cast(self, "bias", dt).view(-1, *[1] * (y.dim() - 2))
        return y.to(x.dtype)


class Conv2d(_ComputeDtype, nn.Conv2d):
    pass


class Conv3d(_ComputeDtype, nn.Conv3d):
    pass


class ConvTranspose2d(_ComputeDtype, nn.ConvTranspose2d):
    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` on batch statistics that also takes one value per
    channel, where torch's own raises: the value is its own mean, so the
    output is JAX's ``(x - mean) * rsqrt(0 + eps) * scale + bias``, the
    bias."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, track_running_stats=False,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.numel() != x.shape[1]:
            return super().forward(x)
        return (x - x) * self.weight.view(1, -1, 1, 1) + self.bias.view(
            1, -1, 1, 1)


def convbn(in_planes: int, out_planes: int, kernel: int, stride: int,
           pad: int, dilation: int, device=None,
           compute_dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """PSMNet ``convbn``: Conv2d (no bias) + BatchNorm2d on batch statistics."""
    return nn.Sequential(
        Conv2d(in_planes, out_planes, kernel, stride,
               padding=dilation if dilation > 1 else pad,
               dilation=dilation, bias=False, device=device,
               compute_dtype=compute_dtype),
        BatchNorm2d(out_planes, device=device))


def convbn_3d(in_planes: int, out_planes: int, kernel: int, stride: int,
              pad: int, device=None,
              compute_dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """PSMNet ``convbn_3d``: Conv3d (no bias) + BatchNorm3d on batch statistics."""
    return nn.Sequential(
        Conv3d(in_planes, out_planes, kernel, stride, padding=pad,
               bias=False, device=device, compute_dtype=compute_dtype),
        nn.BatchNorm3d(out_planes, track_running_stats=False, device=device))


def upsample_bilinear_ac(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with align_corners=True."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def linear_interp_matrix_ac(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) fp32 1-D linear interpolation matrix on the
    align_corners=True grid, on the CPU: row o puts its two weights at
    input position o * (n_in - 1) / (n_out - 1) (the identity when n_out ==
    n_in). The same fp32 arithmetic as JAX's, so the same bits."""
    if n_out == 1 or n_in == 1:
        src = torch.zeros(n_out)
    else:
        src = torch.arange(n_out, dtype=torch.float32) * (n_in - 1) / (
            n_out - 1)
    i0 = src.floor().long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(0, n_in - 1)
    w1 = src - i0
    m = torch.zeros(n_out, n_in)
    rows = torch.arange(n_out)
    m.index_put_((rows, i0), 1.0 - w1, accumulate=True)
    m.index_put_((rows, i1), w1, accumulate=True)
    return m


def bilinear_kernel(kh: int, kw: int) -> np.ndarray:
    """The reference's bilinear deconvolution kernel (Refine.py:121-132)."""
    factor_h, factor_w = (kh + 1) // 2, (kw + 1) // 2
    center_h = factor_h - 1 if kh % 2 == 1 else factor_h - 0.5
    center_w = factor_w - 1 if kw % 2 == 1 else factor_w - 0.5
    og = np.ogrid[:kh, :kw]
    return ((1 - abs(og[0] - center_h) / factor_h)
            * (1 - abs(og[1] - center_w) / factor_w)).astype(np.float32)


@torch.no_grad()
def reference_init_(module: nn.Module, seed: int) -> nn.Module:
    """Seeded reference initialisation, in place, identical on every device.

    Conv weights: normal with std sqrt(2 / (prod(kernel) * out_channels));
    transposed-conv weights: the bilinear kernel on every (in, out) pair;
    biases 0; BN scale 1, bias 0. Numbers come from a CPU
    ``torch.Generator`` in module order and are then copied to the device.
    """
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            k = torch.from_numpy(bilinear_kernel(*m.kernel_size))
            m.weight.copy_(k.expand_as(m.weight))
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            n = math.prod(m.kernel_size) * m.out_channels
            w = torch.randn(m.weight.shape, generator=gen) * math.sqrt(2.0 / n)
            m.weight.copy_(w)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.weight.fill_(1.0)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module

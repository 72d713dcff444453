"""The K-Net forward with its ten 64->64 convs on the conv kernel
(counterpart of ``neuralrgbd_tpu/ops/pallas/conv3d_pair.py::knet_fast_apply``).

Semantics are the JAX chain's (``conv3d_pair.py:345-387``), in the same
operation order:

- ``dres0_0`` (C_in -> 64): conv on bf16-rounded operands with fp32
  accumulation, outside the kernel as in JAX, then fp32 BatchNorm on batch
  statistics and ReLU, then the cast to bf16;
- ``dres0_1``, ``dres{1..4}_{0,1}`` and ``classify_0``: the conv kernel,
  bf16 in and out, on weights packed once per layer (``packed_weights``),
  with the per-channel sum and sum of squares of its fp32
  accumulator; BatchNorm from those sums (``bn_apply``: mean, biased
  variance, ``a``, ``b`` in fp32, then ``z * a + b`` in bf16), ReLU and the
  bf16 residual add, with the skips of ``KNet``;
- ``classify_1`` (64 -> 1): conv on bf16-rounded operands, fp32 result.

The TPU chain's pair packing (``pack_dense``, ``dense_to_xp2``,
``pack_weights``, the WP x-pad and its masks) existed for the 128-lane
tiles and the DMA engine; the port works on plain channels-last
(D, H, W, C) bf16 and the kernel handles the borders. Inference only: the
glue is plain torch, as it is XLA in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.ops.cuda.conv3d import (PackedWeights, conv3d,
                                                  conv3d_plain, pack_weights)


def _layer(knet: KNet, name: str) -> nn.Module:
    """A KNet layer by its JAX name: ``dres2_1`` is ``knet.dres2[2]``."""
    block, j = name.rsplit("_", 1)
    return getattr(knet, block)[2 * int(j)]


def _dhwio(conv: nn.Conv3d) -> torch.Tensor:
    """torch (O, I, kd, kh, kw) -> the JAX layout (kd, kh, kw, I, O)."""
    return conv.weight.permute(2, 3, 4, 1, 0)


def packed_weights(conv: nn.Conv3d) -> PackedWeights:
    """The conv's weights in the kernel's layout, packed once and kept on
    the module until its weight is written in place (its version moves) or
    replaced."""
    w = conv.weight
    key = (w.data_ptr(), w._version)
    hit = getattr(conv, "_packed_weights", None)
    if hit is None or hit[0] != key:
        hit = (key, pack_weights(_dhwio(conv).detach()))
        conv._packed_weights = hit
    return hit[1]


def _bn_fp32(y: torch.Tensor, bn: nn.BatchNorm3d, relu: bool) -> torch.Tensor:
    """JAX ``bn_xla``: fp32 BatchNorm over the voxels, two-pass variance."""
    mean = y.mean((0, 1, 2))
    var = (y - mean).square().mean((0, 1, 2))
    out = (y - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias
    return torch.relu(out) if relu else out


def bn_apply(z: torch.Tensor, ssum: torch.Tensor, ssq: torch.Tensor,
             bn: nn.BatchNorm3d, n_valid: int, relu: bool,
             skip: Optional[torch.Tensor]) -> torch.Tensor:
    """JAX ``bn_apply`` on channels-last bf16 z: BatchNorm from the
    kernel's per-channel sums, then ReLU, then the residual skip."""
    mean = ssum / n_valid
    var = ssq / n_valid - mean * mean
    a = bn.weight * torch.rsqrt(var + bn.eps)
    b = bn.bias - mean * a
    y = z * a.to(z.dtype) + b.to(z.dtype)
    if relu:
        y = torch.relu(y)
    if skip is not None:
        y = y + skip
    return y


@torch.no_grad()
def knet_fast_apply(knet: KNet, vol: torch.Tensor,
                    kernels: bool = True) -> torch.Tensor:
    """The K-Net forward (``models.knet.KNet`` semantics) with the ten
    64->64 convs on the conv kernel. vol: (D, H, W, C_in) -> gain
    (D, H, W) fp32. ``kernels=False`` runs the kernel's plain twin instead,
    on any device."""
    conv = conv3d if kernels else conv3d_plain
    D, H, W, _ = vol.shape
    n_valid = D * H * W

    # dres0_0 and classify_1 stay outside the kernel, as in JAX (conv_xla):
    # the plain conv on bf16-rounded operands with an fp32 result
    first = _layer(knet, "dres0_0")
    y = conv3d_plain(vol, _dhwio(first[0]), torch.float32)
    z = _bn_fp32(y, first[1], relu=True).to(torch.bfloat16)

    def fast(name, x, relu, skip=None):
        layer = _layer(knet, name)
        w = packed_weights(layer[0]) if kernels else _dhwio(layer[0])
        y, ssum, ssq = conv(x, w, torch.bfloat16, True)
        return bn_apply(y, ssum, ssq, layer[1], n_valid, relu, skip)

    z = fast("dres0_1", z, relu=True)                 # cost0
    for block in ("dres1", "dres2", "dres3", "dres4"):
        y = fast(f"{block}_0", z, relu=True)
        z = fast(f"{block}_1", y, relu=False, skip=z)
    z = fast("classify_0", z, relu=True)
    return conv3d_plain(z, _dhwio(knet.classify[2]), torch.float32)[..., 0]

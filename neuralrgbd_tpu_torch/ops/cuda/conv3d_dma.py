"""Counterpart of ``neuralrgbd_tpu/ops/pallas/conv3d_dma.py::conv3d_dma``.

The TPU kernel built im2col slabs with async DMAs from a padded,
row-flattened volume (``pad_volume`` / ``unpad_volume``); both layouts
existed for the TPU's DMA alignment and are not ported. The function runs
on the conv kernel of ``ops.cuda.conv3d``, which handles the borders
itself. Nothing in the JAX package wires it in; it is kept so that every
TPU kernel has a named counterpart.
"""

from __future__ import annotations

import torch

from neuralrgbd_tpu_torch.ops.cuda.conv3d import _check_channels, conv3d


def conv3d_dma(x: torch.Tensor, w: torch.Tensor, with_stats: bool = False):
    """3-D conv, kernel 3, stride 1, padding 1, no bias.

    x: (D, H, W, C); w: (3, 3, 3, C, N). Returns (D, H, W, N) bf16 values
    (fp32 accumulation, cast at the end), plus the per-channel fp32
    (sum, sumsq) when ``with_stats``. Requires C % 8 == 0 and N % 8 == 0.
    """
    _check_channels(x.shape[-1], w.shape[-1])
    return conv3d(x, w, torch.bfloat16, with_stats)

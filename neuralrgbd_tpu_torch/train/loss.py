"""Training losses (counterpart of ``neuralrgbd_tpu/train/loss.py``).

The reference trains with 4 NLL terms over digitized depth bins with
ignore_index=0 (train_utils/train_KVNet.py:103-118) plus a legacy
L1+variance branch (:122-146). Bin 0 means "depth below d_candi[0]", the
masked or invalid pixels, which the loaders zero out (scanNet.py:373-405).
"""

from __future__ import annotations

import torch

from neuralrgbd_tpu_torch.ops.dpv import depth_regression, depth_variance


def nll_dpv_loss(log_dpv: torch.Tensor, labels: torch.Tensor,
                 ignore_index: int = 0) -> torch.Tensor:
    """Mean NLL of the label bin over the pixels whose label is not
    ``ignore_index`` (0 if there is none), labels clipped to [0, D-1]:
    ``F.nll_loss(..., ignore_index=0)``'s mean.

    log_dpv: (D, H, W) log-probabilities; labels: (H, W) integer bins.
    Stays on the device: no host sync.
    """
    D = log_dpv.shape[0]
    labels = labels.long().clamp(0, D - 1)
    picked = log_dpv.gather(0, labels[None])[0]
    mask = (labels != ignore_index).to(log_dpv.dtype)
    return -(picked * mask).sum() / mask.sum().clamp(min=1.0)


def l1_variance_loss(dpv_refined_depth: torch.Tensor,
                     dmap_imgsize: torch.Tensor, dpv_low: torch.Tensor,
                     d_candi: torch.Tensor,
                     weight_var: float = 1e-3) -> torch.Tensor:
    """Legacy L1 + variance loss (train_utils/train_KVNet.py:122-146).

    dpv_refined_depth: (H, W) regressed depth at image size; dmap_imgsize:
    (H, W) metric ground truth (0 = invalid); dpv_low: (D, h, w) log-DPV for
    the variance regularizer.
    """
    mask = (dmap_imgsize > 0).to(dpv_refined_depth.dtype)
    l1 = ((dpv_refined_depth - dmap_imgsize).abs() * mask).sum() / \
        mask.sum().clamp(min=1.0)
    dm = depth_regression(dpv_low, d_candi)
    var = depth_variance(dpv_low, dm, d_candi).mean()
    return l1 + weight_var * var

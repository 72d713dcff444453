"""Plane-sweep cost volume on a hand-written CUDA kernel (``csrc/sweep_fused.cu``).

Counterpart of ``neuralrgbd_tpu/ops/pallas/sweep_fused.py``. The wrapper
computes the sample coordinates with the plain ``_sweep_pixel_coords``,
exactly as the JAX wrapper does, and the kernel does the gather and the
reduction. Unlike the TPU kernel it has no band precondition: it is exact
for any pose.

The features keep the JAX layouts in the signatures, ref (H, W, C) and
srcs (V, H, W, C), but the kernel reads them through their strides: a
channel-planar tensor seen as channels-last (``feat.permute(0, 2, 3, 1)``
of a (V, C, H, W) tensor, as ``KVNet`` passes them) is read without a
copy, and that layout is the one whose tap reads coalesce.
"""

from __future__ import annotations

import ctypes

import torch

from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda import build, count_launch
from neuralrgbd_tpu_torch.ops.sweep import (_sweep_pixel_coords,
                                            sweep_cost_volume_from_coords)

NAME = "sweep_fused"
SOURCE = "neuralrgbd_tpu_torch/csrc/sweep_fused.cu"
REPLACES = "neuralrgbd_tpu/ops/pallas/sweep_fused.py:185"

launches = 0  # kernel launches (``count_launch``); chip_smoke.py resets it

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_longlong] + [ctypes.c_int] * 6
             + [ctypes.c_int, ctypes.c_void_p])

# The plain twin of ``sweep_kernel``: same signature, F.grid_sample taps.
sweep_plain = sweep_cost_volume_from_coords


def sweep_kernel(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                 coords: torch.Tensor, sigma: float, feat_dist: str = "L2",
                 keep_last_channels: int = 0):
    """``sweep_plain`` on the CUDA kernel: ref_feat (H, W, C), src_feats
    (V, H, W, C), coords (V, D, H*W, 2), all float32 on one CUDA device.
    The features may have any non-negative strides."""
    V, H, W, C = src_feats.shape
    D = coords.shape[1]
    k = keep_last_channels
    if feat_dist not in ("L2", "L1"):
        raise ValueError(f"undefined feature distance: {feat_dist}")
    if not 0 <= k <= C:
        raise ValueError(f"keep_last_channels={k} outside [0, {C}]")
    dev = src_feats.device
    for name, t, shape in (("ref_feat", ref_feat, (H, W, C)),
                           ("src_feats", src_feats, (V, H, W, C)),
                           ("coords", coords, (V, D, H * W, 2))):
        if (t.device != dev or dev.type != "cuda" or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{NAME}: {name} must be float32 {shape} on one "
                             f"CUDA device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("ref_feat", ref_feat), ("src_feats", src_feats)):
        if min(t.stride()) < 0 or max(t.stride()[-3:]) >= 2**31:
            raise ValueError(f"{NAME}: {name} strides {t.stride()} must be "
                             f"non-negative, and below 2^31 within an image")
    crd = coords.contiguous()
    cost = torch.empty((D, H, W), dtype=torch.float32, device=dev)
    kept = (torch.empty((V, D, H, W, k), dtype=torch.float32, device=dev)
            if k else None)
    fn = build.kernel_function(NAME, _ARGTYPES)
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(src_feats.data_ptr(), ref_feat.data_ptr(), crd.data_ptr(),
                 cost.data_ptr(), kept.data_ptr() if k else None, V, D, H, W,
                 C, k, int(feat_dist == "L1"), float(sigma),
                 *src_feats.stride(), *ref_feat.stride(), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)
    return (cost, kept) if k else cost


def sweep_cost_volume_fused(ref_feat: torch.Tensor, src_feats: torch.Tensor,
                            Rs: torch.Tensor, ts: torch.Tensor, cam: Camera,
                            d_candi: torch.Tensor, sigma: float,
                            feat_dist: str = "L2",
                            keep_last_channels: int = 0):
    """Same signature and result as ``ops.sweep.sweep_cost_volume``.

    CPU tensors take the plain twin; CUDA tensors launch the kernel.
    """
    H, W = ref_feat.shape[:2]
    coords = _sweep_pixel_coords(cam, Rs, ts, d_candi, H, W)  # (V, D, HW, 2)
    fn = sweep_plain if src_feats.device.type == "cpu" else sweep_kernel
    return fn(ref_feat, src_feats, coords, sigma, feat_dist,
              keep_last_channels)

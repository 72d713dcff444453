"""The full KV-Net: D-Net measurement + K-Net temporal fusion + R-Net refine
(counterpart of ``neuralrgbd_tpu/models/kvnet.py``).

One call runs one lane (trajectory), so BatchNorm sees the V+1 frames of
one window, exactly as the reference's one-trajectory-per-GPU forward.
Module names give the reference KVNET's state_dict keys
(``feature_extractor.feature_extraction.*``, ``d_net.*``, ``kv_net.*``,
``r_net.*``).

Unlike JAX, where a static graph runs the K-Net on the first frame too and
``jnp.where`` discards it, eager PyTorch skips the K-Net when the
prediction is invalid; the outputs are the same.

The heads and D-Net branches of the JAX KVNet, each as JAX's:

- ``refine_net='DPV'`` (the default): the R-Net refines the DPV to image
  resolution; with ``refine_dup`` it also upsamples D 4x (4D bins).
- ``refine_net='DGF'``: the DPV is regressed to a low-res depth map and
  the deep guided filter upsamples it (``models/guided_filter.py``): the
  refined fields are then (H, W) depth maps, not DPVs.
- ``refine_costv``: three D->D 3x3 convs on the cost volume before the
  softmax (``d_net.conv0``, ``d_net.conv0_1``, ``d_net.conv0_2``).
- ``dnet_bayes``: the posterior is ``log_softmax(bv_cur + bv_predict)``,
  with no K-Net; the model then has no ``kv_net`` parameters, as JAX's
  has none, and ``fast_knet`` is moot.

The three inference deviations of the JAX KVNet run here, each as JAX's:
``cfg.knet_coarse_d`` (the K-Net at D/cd), ``cfg.fe_per_frame_bn`` (B=1
BatchNorm statistics in the feature extractor) with ``precomputed``
features (the cached-feature rollout), and ``cfg.dtype`` (the convs'
dtype; see ``models/layers.py``). None of them adds a parameter: the
state_dict and its bridge are the same for every setting.

The model is built on the CUDA card unless the caller names another
device (the CPU tests pass ``device="cpu"``).

``paired_knet`` and ``packed_fe`` are accepted as JAX's KVNet takes them
(``neuralrgbd_tpu/models/kvnet.py:73-81``) and run the plain modules.
In JAX they pack two (or four) pixels into a TPU's 128-lane channel rows
(``models/knet_paired.py``, ``models/fe_packed.py``): the same convs in
another summation order, a layout for the TPU's lanes that a GPU has no
use for.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neuralrgbd_tpu_torch.config import ModelConfig
from neuralrgbd_tpu_torch.models.feature_extractor import FeatureExtractor
from neuralrgbd_tpu_torch.models.guided_filter import RefineNetDGF
from neuralrgbd_tpu_torch.models.knet import KNet
from neuralrgbd_tpu_torch.models.layers import (Conv2d,
                                                linear_interp_matrix_ac,
                                                reference_init_)
from neuralrgbd_tpu_torch.models.rnet import RNet
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.cuda.conv3d_pair import knet_fast_apply
from neuralrgbd_tpu_torch.ops.cuda.sweep_fused import sweep_cost_volume_fused
from neuralrgbd_tpu_torch.ops.sweep import (sweep_cost_volume,
                                            warp_to_ref_over_depths)
from neuralrgbd_tpu_torch.utils import profiler


class KVNetOutput(NamedTuple):
    """All DPVs are log scale: low-res (D, h, w); refined (D, H, W), or
    (4D, H, W) with ``refine_dup``. With ``refine_net='DGF'`` the two
    refined fields are (H, W) depth maps in metres instead."""

    bv_cur: torch.Tensor            # D-Net measurement
    dpv: torch.Tensor               # fused posterior (== bv_cur on first frame)
    dpv_cur_refined: torch.Tensor   # R-Net(bv_cur)
    dpv_refined: torch.Tensor       # R-Net(dpv)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a ``knet_coarse_d`` that does not divide
    ``ndepth`` (JAX raises it in the forward). Every head of the JAX KVNet
    runs; as in JAX, a ``refine_net`` other than 'DGF' is the DPV head."""
    check_coarse_d(cfg.knet_coarse_d, cfg.ndepth)


def check_coarse_d(cd: int, D: int) -> None:
    if cd > 1 and D % cd:
        raise ValueError(f"knet_coarse_d={cd} must divide ndepth={D}")


class KVNet(nn.Module):
    def __init__(self, cfg: ModelConfig, device=torch.device("cuda"),
                 seed: int = 0, single_refine: bool = False,
                 paired_knet: bool = False, packed_fe: bool = False):
        """``device``: where the parameters live, the CUDA card by default;
        without one, ask for the CPU explicitly. ``single_refine``:
        inference-only, refine just the posterior (the two R-Net passes
        agree whenever the measurement's refinement is used); training
        needs both. ``paired_knet``, ``packed_fe``: JAX's TPU lane
        packings, run here on the plain modules (module docstring)."""
        super().__init__()
        self.paired_knet, self.packed_fe = bool(paired_knet), bool(packed_fe)
        check_supported(cfg)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "KVNet builds on the CUDA card by default and this process "
                "sees none; pass device='cpu' to build on the CPU")
        self.cfg = cfg
        self.single_refine = single_refine
        dt = getattr(torch, cfg.dtype)           # the convs' dtype
        dt = None if dt == torch.float32 else dt  # None: plain fp32 convs
        self.feature_extractor = nn.ModuleDict({
            "feature_extraction": FeatureExtractor(cfg.feature_dim, device,
                                                   dt)})
        if not cfg.dnet_bayes:
            self.kv_net = KNet(cfg.kvnet_in_channels, cfg.kv_feature_dim,
                               device, compute_dtype=dt)
        if cfg.refine_net == "DGF":
            self.r_net = RefineNetDGF(device=device, compute_dtype=dt)
        else:
            self.r_net = RNet(D=cfg.ndepth, C0=cfg.feature_dim, C1=32,
                              C2=cfg.refine_channel, device=device,
                              compute_dtype=dt, upsample_D=cfg.refine_dup)
        if cfg.refine_costv:
            # basic.py:189-196: conv2d_leakyRelu x2 + a plain conv2d, D
            # channels, on the cost volume before the softmax
            D = cfg.ndepth
            conv = lambda: Conv2d(D, D, 3, 1, padding=1, bias=True,
                                  device=device, compute_dtype=dt)
            self.d_net = nn.Sequential(OrderedDict(
                conv0=nn.Sequential(conv(), nn.LeakyReLU()),
                conv0_1=nn.Sequential(conv(), nn.LeakyReLU()),
                conv0_2=conv()))
        self._interp: dict = {}
        reference_init_(self, seed)

    def features(self, frames: torch.Tensor, kernels: bool = True) -> tuple:
        """(B, 3, H, W) -> (layer1, feat) of the feature extractor: one
        batch (joint BatchNorm statistics), or with ``fe_per_frame_bn`` one
        call per frame (B=1 statistics, the weights shared). ``kernels``:
        its convs on the fp32 conv kernel where the call allows it
        (``FeatureExtractor.forward``)."""
        fe = self.feature_extractor["feature_extraction"]
        if not self.cfg.fe_per_frame_bn:
            return fe(frames, kernels)
        layer1, feat = zip(*(fe(frames[i:i + 1], kernels)
                             for i in range(frames.shape[0])))
        return torch.cat(layer1), torch.cat(feat)

    def interp(self, n_in: int, n_out: int, device) -> torch.Tensor:
        """``linear_interp_matrix_ac(n_in, n_out)`` on ``device``, copied
        there once (a copy from the host waits for the card)."""
        key = (n_in, n_out, torch.device(device))
        if key not in self._interp:
            self._interp[key] = linear_interp_matrix_ac(n_in, n_out).to(
                device)
        return self._interp[key]

    def forward(
        self,
        ref_frame: torch.Tensor,    # (H, W, 3) normalised RGB
        src_frames: torch.Tensor,   # (V, H, W, 3)
        src_poses: torch.Tensor,    # (V, 4, 4) relative extrinsics ref -> src
        cam: Camera,                # intrinsics at DPV (1/4) resolution
        d_candi: torch.Tensor,      # (D,)
        bv_predict: torch.Tensor,   # (D, h, w) log-DPV prediction
        bv_valid: bool,             # is bv_predict usable? (host bool)
        precomputed: Optional[tuple] = None,
        kernels: bool = True,
        fast_knet: bool = False,
        coarse_d: Optional[int] = None,
    ) -> KVNetOutput:
        """``precomputed``: ``(layer1 (V+1, 32, H/2, W/2), feat (V+1, F, h,
        w))`` in [srcs..., ref] order, the port's planar layout; it skips
        the feature extractor (the cached-feature rollout). ``kernels``
        routes the plane sweep (and, with ``fast_knet``, the K-Net convs)
        through the CUDA kernel wrappers, which take their plain twins for
        CPU tensors, and the feature extractor's convs and the K-Net's,
        in fp32 inference on the card, through their conv kernels
        (``ops.cuda.conv2d_bn``, ``ops.cuda.conv3d_f32``); False runs the
        plain versions on any device.
        ``fast_knet`` (inference only, off by default as in JAX) runs the
        K-Net as ``ops.cuda.conv3d_pair.knet_fast_apply``: its ten 64->64
        convs in bf16 with fp32 accumulation. As in JAX it applies only
        when ``kv_feature_dim`` is 64; any other width takes the plain
        K-Net. ``coarse_d`` overrides ``cfg.knet_coarse_d`` (the step's
        ``coarse_knet``). Inside a traced inference step
        (``utils.profiler.stamped``) it stamps the device's time after the
        D-Net, after the sweep and after the fusion."""
        cfg = self.cfg
        V, H, W, _ = src_frames.shape

        # ---- D-Net: features of the V+1 frames ----
        frames = torch.cat([src_frames, ref_frame[None]]).permute(0, 3, 1, 2)
        if precomputed is not None:
            layer1, feat = precomputed
        else:                                      # (V+1, 32, .), (V+1, F, h, w)
            layer1, feat = self.features(frames.contiguous(), kernels)
        h, w = feat.shape[-2:]
        ints = F.avg_pool2d(frames, W // w)        # (V+1, 3, h, w)
        sw = torch.cat([feat, ints], 1) if cfg.use_img_intensity else feat
        # channels-last view of the planar features: the sweep kernel reads
        # them through strides, coalesced in this layout, without a copy
        sw = sw.permute(0, 2, 3, 1)                # (V+1, h, w, C)
        profiler.mark(profiler.DNET)

        Rs, ts = src_poses[:, :3, :3], src_poses[:, :3, 3]
        keep = 3 if cfg.use_img_intensity else 0
        sweep = sweep_cost_volume_fused if kernels else sweep_cost_volume
        swept = sweep(sw[-1], sw[:-1], Rs, ts, cam, d_candi,
                      sigma=cfg.sigma_soft_max, feat_dist=cfg.feat_dist,
                      keep_last_channels=keep)
        cost, warped_rgb = swept if keep else (swept, None)
        if cfg.refine_costv:
            cost = self.d_net(cost[None])[0]
        bv_cur = F.log_softmax(-cost, dim=0)
        profiler.mark(profiler.SWEEP)

        if cfg.refine_net == "DGF":
            def refine(dpv_log):
                # depth-regress the low-res DPV, guided-filter upsample
                # (KVNET.py:127-131,178-179): an (H, W) depth map
                dmap_lr = torch.einsum("dhw,d->hw", dpv_log.exp(), d_candi)
                return self.r_net(dmap_lr[None], frames[-1:])[0]
        else:
            def refine(dpv_log):
                return self.r_net(dpv_log.exp()[None], feat[-1:],
                                  layer1[-1:], frames[-1:])[0]

        if bv_valid and cfg.dnet_bayes:
            # in-net Bayesian filtering (basic.py:309-321): the log-space
            # product of measurement and prediction, no learned gain
            dpv = F.log_softmax(bv_cur + bv_predict, dim=0)
        elif bv_valid:
            # ---- K-Net temporal fusion ----
            if warped_rgb is None:
                warped_rgb = warp_to_ref_over_depths(
                    ints[:-1].permute(0, 2, 3, 1), Rs, ts, cam, d_candi)
            D = bv_cur.shape[0]
            # channel order of the reference's kvnet_in_vol: view v's warped
            # RGB at v*3+c, then the ref RGB, then bv_cur - bv_predict
            vol = torch.cat([
                warped_rgb.permute(0, 4, 1, 2, 3).reshape(V * 3, D, h, w),
                ints[-1][:, None].expand(3, D, h, w),
                (bv_cur - bv_predict)[None],
            ])
            # coarse-D K-Net: the volume down along D on the align_corners
            # grid, the K-Net at D/cd, the gain back up in fp32
            cd = max(1, int(cfg.knet_coarse_d if coarse_d is None
                            else coarse_d))
            if cd > 1:
                check_coarse_d(cd, D)
                vol = torch.einsum("od,cdhw->cohw",
                                   self.interp(D, D // cd, vol.device), vol)
            if fast_knet and cfg.kv_feature_dim == 64:
                gain = knet_fast_apply(self.kv_net,
                                       vol.permute(1, 2, 3, 0), kernels)
            else:
                gain = self.kv_net(vol[None], kernels)[0]   # (D/cd, h, w)
            if cd > 1:
                gain = torch.einsum("od,dhw->ohw",
                                    self.interp(D // cd, D, gain.device),
                                    gain.float())
            dpv = F.log_softmax(gain + bv_predict, dim=0)
        else:
            dpv = bv_cur
        if bv_valid:
            profiler.mark(profiler.KNET)

        if self.single_refine:
            dpv_refined = dpv_cur_refined = refine(dpv)
        else:
            dpv_cur_refined = refine(bv_cur)
            dpv_refined = refine(dpv) if bv_valid else dpv_cur_refined
        return KVNetOutput(bv_cur=bv_cur, dpv=dpv,
                           dpv_cur_refined=dpv_cur_refined,
                           dpv_refined=dpv_refined)

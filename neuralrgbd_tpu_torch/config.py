"""Model, data and training configuration (copies of
``neuralrgbd_tpu/config.py``'s ``ModelConfig``, ``DataConfig`` and
``TrainConfig``).

The port keeps its own copies so that it imports nothing of the JAX package;
``tests/test_torch_standalone.py`` holds them equal to the originals, field
for field and property for property.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """KV-Net hyperparameters (reference defaults: run_demo.sh / docs/TE.md)."""

    feature_dim: int = 64          # --feature_dim (D-Net feature channels)
    kv_feature_dim: int = 64       # KVNet_feature_dim == feature_dim at all call sites
    ndepth: int = 64               # --ndepth
    d_min: float = 0.1             # --d_min (indoor; KITTI: 1.0)
    d_max: float = 5.0             # --d_max (indoor; KITTI: 60.0)
    sigma_soft_max: float = 10.0   # --sigma_soft_max
    t_win_r: int = 2               # --t_win  (=> 4 source views + ref)
    feat_dist: str = "L2"
    use_img_intensity: bool = True
    refine_channel: int = 3        # RGB guide for the R-Net
    # --refineNet_name (KVNET.py:80-85): 'DPV' refines the probability
    # volume (RefineNet_DPV_upsample); 'DGF' regresses a low-res depth map
    # and upsamples it with the deep guided filter (RefineNet_DGF). With
    # 'DGF' the refined outputs are depth maps, not DPVs.
    refine_net: str = "DPV"
    # D_NET_BASIC optional branches, both OFF on the reference main path:
    # refine_costv adds 3 extra 2-D convs on the cost volume pre-softmax
    # (basic.py:189-196,304-308; note the reference's own constructor
    # crashes if enabled — `self.apply(self.weight_init)` names a method
    # that doesn't exist, basic.py:196 vs 198 — so it is dead there).
    refine_costv: bool = False
    # dnet_bayes fuses the prediction INSIDE D-Net (BV + BV_predict, then
    # log-normalize; basic.py:309-321) instead of the learned K-Net gain —
    # the reference's baseline-model filtering framework.
    dnet_bayes: bool = False
    # refine_dup (train_utils/train_KVNet.py:25,74-75; KVNET.py:38,59,85):
    # the R-Net upsamples the DEPTH dimension 4x (RefineNet_DPV_upsample
    # with upsample_D, Refine.py:44-49) and the two image-size NLL terms
    # train against 4*D-bin labels (dmap_up4_imgsize_digit,
    # scanNet.py:419-422). Off by default in the reference too.
    refine_dup: bool = False
    # BatchNorm: the reference uses track_running_stats=False, i.e. batch
    # statistics at train AND eval (psm_submodule.py:10-16). Keep True for
    # weight-import parity; False switches to standard running-stats BN.
    bn_batch_stats: bool = True
    # Coarse-D K-Net (deviation, default off): run the K-Net gain at D/knet_coarse_d
    # — the input volume linearly downsampled along D (align_corners=True
    # grid) and the 1-channel gain upsampled back with the reference's own
    # trilinear D-upsample branch (basic.py:128-139, ported at
    # models/knet.py up_sample_ratio). Halves (at 2) the dominant 3-D-conv
    # cost; accuracy-gated like cache_features/bf16 (PERF.md "Coarse-D
    # K-Net"). 1 = exact reference semantics. Differentiable, so training
    # can fine-tune with it enabled.
    knet_coarse_d: int = 1
    # Per-frame BatchNorm statistics in the feature extractor (deviation,
    # default off): the reference featurizes the V+1 window jointly, so BN
    # statistics span the window (basic.py:245-252); the cached-feature
    # rollout (infer/rollout.make_rollout(cache_features=True)) featurizes
    # each frame alone (B=1 statistics) — the property that makes caching
    # coherent. Setting this True makes the MODEL itself use per-frame
    # statistics, so TRAINING optimizes the exact deployment semantics
    # (VERDICT r4 item 3). Inference with cache_features=True is then the
    # semantics the weights were trained under, not a deviation.
    fe_per_frame_bn: bool = False
    dtype: str = "float32"         # compute dtype for convs ("bfloat16" ok)
    # Inference-only conv compute dtype, applied by make_infer_step on TPU
    # (training and the CPU parity/test backend keep ``dtype``). Validated
    # on trained weights: tools/eval_bf16.py, PERF.md round-2 table.
    infer_dtype: Optional[str] = "bfloat16"

    @property
    def d_candi(self) -> np.ndarray:
        # train_KVNet.py:175: np.linspace(d_min, d_max, ndepth)
        return np.linspace(self.d_min, self.d_max, self.ndepth).astype(np.float32)

    @property
    def d_candi_up4(self) -> np.ndarray:
        # scanNet.py:327: linspace(d_candi.min(), d_candi.max(), 4*D) — the
        # refine_dup label grid. (train_KVNet.py:75 regresses display depth
        # on linspace(0, d_max, 4*D) instead; that grid does not match the
        # labels the net is trained against, so depth regression here uses
        # THIS grid.)
        return np.linspace(self.d_min, self.d_max,
                           4 * self.ndepth).astype(np.float32)

    @property
    def n_views(self) -> int:
        return 2 * self.t_win_r

    @property
    def kvnet_in_channels(self) -> int:
        # KVNET.py:75: 3*(t_win_r*2+1) + 1  (V warped RGB + ref RGB + dpv diff)
        return 3 * (2 * self.t_win_r + 1) + 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "scannet"       # scannet | 7scenes | kitti | single_folder
    data_root: str = "/datasets/scan-net-5-frame"
    split_txt: Optional[str] = None
    img_size: Tuple[int, int] = (384, 256)   # (W, H)
    dpv_scale: float = 0.25        # resize_dmap
    frame_interval: int = 5        # ScanNet: multiples of 5
    dat_index_step: int = 1        # 7Scenes test uses 3
    crop_w: Optional[int] = None   # KITTI: 384


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-5               # --LR (Adam, betas (.9,.999))
    # LR schedule (deviation: the reference trains at constant LR,
    # train_KVNet.py:264 — round-3 campaigns showed post-peak regression
    # that a decay schedule removes; TRAIN.md "Round-4"). 'constant'
    # reproduces the reference. 'cosine' decays lr -> lr*lr_min_ratio over
    # lr_decay_steps (with lr_warmup_steps linear warmup); 'step' halves
    # the LR every lr_decay_steps.
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0        # total decay horizon (cosine) / period (step)
    lr_min_ratio: float = 0.1      # cosine floor as a fraction of lr
    lr_warmup_steps: int = 0
    n_epoch: int = 10              # local_train_scanNet.sh (KITTI: 20)
    batch_size: int = 0            # 0 => one lane per device
    pose_noise_level: float = 0.0  # --pose_noise_level
    # photometric augmentation (data/augment.py): the reference SHIPS the
    # jitter+PCA-lighting suite (utils/preprocess.py:67-77) but never wires
    # it into its train loop; here --augment applies it with one parameter
    # draw per lane per trajectory group (photoconsistency-preserving)
    augment: bool = False
    weight_var: float = 1e-3       # --weight_var (L1 loss branch)
    loss_type: str = "NLL"
    grad_clip_max: Optional[float] = None  # reference parsed but never applied
    save_model_interv: int = 5000
    tb_add_img_interv: int = 50
    seed: int = 0
    exp_name: str = "exp"
    save_dir: str = "saved_models"

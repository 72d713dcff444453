"""The training step (counterpart of ``neuralrgbd_tpu/train/step.py``;
reference: train_utils/train_KVNet.py:20-203).

One call = the forward of every valid lane, the 4-term NLL loss, the
Adam update, and the detached prediction resample that carries the
recurrence to the next frame. Lane validity (invalid poses or missing
depth) weighs the loss, as in JAX.

How the port meets JAX's semantics:

- Lanes. JAX ``vmap``s the lanes, each with its own BatchNorm statistics.
  Here each lane runs its own forward, and its own ``backward`` of
  ``loss_lane / n_valid``: the gradients accumulate to those of JAX's
  mean over valid lanes without holding every lane's graph. ``n_valid``
  comes from the host's ``lane_valid``. A lane with ``lane_valid`` false
  adds nothing to the loss in JAX, so here it skips its forward; its row
  of the carry is then the uniform log(1/D) (JAX computes a row the loop
  ignores, since the lane's carry is invalid on the next frame).
- The update is optax's ``chain(clip_by_global_norm, adam)`` in PyTorch:
  the clip as optax writes it (``g / norm * max`` only when ``norm >=
  max``, no epsilon, unlike ``clip_grad_norm_``), ``torch.optim.Adam``
  with optax's betas and eps, and the learning rate of optax's schedule
  read at its 0-based count before the update. Every parameter is
  updated on every step, with a zero gradient where the loss does not
  reach it (the K-Net on a first frame), as optax updates every leaf:
  the gradients are zeroed, never set to None.
- The forward runs on the plain ops (``kernels=False`` in ``KVNet``): JAX
  trains on its XLA sweep, not on the Pallas one, and the sweep kernel
  has no backward. The carry runs on the resample kernel,
  ``predict_next_cuda``, one launch for all lanes.
- The whole step, backward and update included, runs inside
  ``infer.step.step_numerics(False)`` (fp32 convs, no TF32, deterministic
  cuDNN algorithms) and ``ops.sampling.deterministic_backward()``: the
  image gradients of the sweep's ``F.grid_sample`` and of the feature
  extractor's bilinear ``F.interpolate`` are summed in a fixed order
  instead of by the card's atomic adds, so two runs of the same steps
  give the same bits (ROADMAP Queue C, C2). The forwards are unchanged.
- No host sync: the loss stays on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.infer.step import predict_next, step_numerics
from neuralrgbd_tpu_torch.models.kvnet import KVNet, check_supported
from neuralrgbd_tpu_torch.ops.camera import Camera
from neuralrgbd_tpu_torch.ops.dpv import depth_regression
from neuralrgbd_tpu_torch.ops.rotations import (apply_pose_noise,
                                                draw_pose_noise)
from neuralrgbd_tpu_torch.ops.sampling import deterministic_backward
from neuralrgbd_tpu_torch.train.loss import l1_variance_loss, nll_dpv_loss

BETAS = (0.9, 0.999)   # optax.adam's defaults, train_KVNet.py:264
EPS = 1e-8


def make_lr_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """``count -> learning rate``, optax's schedule for ``tcfg`` written out
    (JAX: ``neuralrgbd_tpu/train/step.py:43``), read at optax's 0-based
    count, before the update:

    - 'constant' (or ``lr_decay_steps <= 0``): ``lr``, the reference's;
    - 'cosine': ``warmup_cosine_decay_schedule``: from 0.0 (``lr`` without
      warm-up) linearly to ``lr`` over ``lr_warmup_steps``, then cosine
      down to ``lr * lr_min_ratio`` at ``lr_decay_steps``, a horizon that
      includes the warm-up, and held there;
    - 'step': ``exponential_decay(rate 0.5, staircase=True)``: halved every
      ``lr_decay_steps``.
    """
    lr = tcfg.lr
    if tcfg.lr_schedule == "constant" or tcfg.lr_decay_steps <= 0:
        if tcfg.lr_schedule not in ("constant", "cosine", "step"):
            raise ValueError(f"unknown lr_schedule: {tcfg.lr_schedule}")
        return lambda count: lr
    if tcfg.lr_schedule == "cosine":
        warm, horizon = tcfg.lr_warmup_steps, tcfg.lr_decay_steps
        decay = horizon - warm
        if decay <= 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, "
                f"got decay_steps={decay}.")
        init = 0.0 if warm else lr
        end = lr * tcfg.lr_min_ratio
        alpha = 0.0 if lr == 0.0 else end / lr

        def cosine(count: int) -> float:
            if count < warm:
                return (init - lr) * (1.0 - count / warm) + lr
            t = min(count - warm, decay)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay))
                         + alpha)

        return cosine
    if tcfg.lr_schedule == "step":
        period = tcfg.lr_decay_steps
        return lambda count: lr if count <= 0 else lr * 0.5 ** (count // period)
    raise ValueError(f"unknown lr_schedule: {tcfg.lr_schedule}")


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place and on the device: every
    gradient becomes ``g / norm * max_norm`` where the global norm is at
    least ``max_norm``, and stays as it is below it."""
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm), torch.full_like(
        norm, max_norm))
    for g in grads:
        g.div_(div).mul_(mul)


@dataclasses.dataclass
class TrainState:
    """The model, its Adam state and the update count (JAX's ``TrainState``
    with ``params`` and ``opt_state`` in the module and the optimizer)."""

    model: KVNet
    optimizer: torch.optim.Adam
    lr: Callable[[int], float]
    grad_clip_max: Optional[float] = None
    step: int = 0

    def apply_gradients(self) -> None:
        """One optax-ordered update from the gradients in ``.grad``: the
        clip, the learning rate at count ``step``, Adam; then the count."""
        if self.grad_clip_max is not None:
            clip_by_global_norm_([p.grad for p in self.model.parameters()],
                                 self.grad_clip_max)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                       model: Optional[KVNet] = None,
                       device=torch.device("cuda")) -> TrainState:
    """A ``TrainState`` around ``model``, or around a new ``KVNet`` (both
    R-Net passes; seeded from ``tcfg.seed``) on ``device``, the card by
    default. Every parameter gets a zero gradient now, so that Adam
    updates it on every step (see the module docstring)."""
    if model is None:
        model = KVNet(cfg, device=device, seed=tcfg.seed)
    if model.single_refine:
        raise ValueError("training needs both R-Net passes: build the KVNet "
                         "with single_refine=False")
    params = list(model.parameters())
    for p in params:
        p.grad = torch.zeros_like(p)
    lr = make_lr_schedule(tcfg)
    optimizer = torch.optim.Adam(params, lr=lr(0), betas=BETAS, eps=EPS)
    return TrainState(model=model, optimizer=optimizer, lr=lr,
                      grad_clip_max=tcfg.grad_clip_max)


class TrainStepOutput(NamedTuple):
    state: TrainState
    loss: torch.Tensor          # () on the device
    bv_predict: torch.Tensor    # (N, D, h, w) detached prediction, next frame
    depth_lowres: torch.Tensor  # (N, h, w) E[d] of the fused DPV (logging)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, kernels: bool = True):
    """Returns ``train_step(state, batch, bv_predict, bv_valid,
    generator=None) -> TrainStepOutput``; ``state`` is updated in place and
    returned.

    batch dict (leading N = lanes), tensors on the model's device:
      ref, srcs, poses, K, pose_next   as in ``infer.step``
      dmap_digit         (N, h, w) integer  digitized GT at DPV resolution
      dmap_imgsize_digit (N, H, W) integer  digitized GT at image resolution
      dmap_imgsize       (N, H, W) float    metric GT (the L1 loss)
    and ``lane_valid``: N host bools (numpy), the lanes that count.
    ``bv_predict`` (N, D, h, w) on the device; ``bv_valid``: N host bools.
    ``generator`` draws the pose noise (``tcfg.pose_noise_level > 0``).

    ``kernels`` runs the carry on the resample kernel (its plain twin for
    CPU tensors); False runs it on the plain ops lane by lane. The forward
    runs on the plain ops either way.
    """
    check_supported(cfg)
    if tcfg.loss_type not in ("NLL", "L1"):
        raise ValueError(f"unknown loss_type: {tcfg.loss_type}")
    d_candis: dict = {}   # per device: copied there once (a copy syncs)

    def lane_loss(model, batch, n, d_candi, bv_predict, bv_valid):
        out = model(batch["ref"][n], batch["srcs"][n], batch["poses"][n],
                    Camera(K=batch["K"][n]), d_candi, bv_predict[n],
                    bv_valid, kernels=False)
        # JAX's jnp.where(bv_valid, fused, 0.0) is this host branch
        if tcfg.loss_type == "NLL":
            # 4 NLL terms (train_utils/train_KVNet.py:103-118)
            digit, img_digit = batch["dmap_digit"][n], \
                batch["dmap_imgsize_digit"][n]
            loss = nll_dpv_loss(out.bv_cur, digit) + nll_dpv_loss(
                out.dpv_cur_refined, img_digit)
            if bv_valid:
                loss = loss + (nll_dpv_loss(out.dpv, digit) + nll_dpv_loss(
                    out.dpv_refined, img_digit))
        else:
            # legacy L1 + variance (train_utils/train_KVNet.py:122-146)
            gt = batch["dmap_imgsize"][n]
            loss = l1_variance_loss(
                depth_regression(out.dpv_cur_refined, d_candi), gt,
                out.bv_cur, d_candi, tcfg.weight_var)
            if bv_valid:
                loss = loss + l1_variance_loss(
                    depth_regression(out.dpv_refined, d_candi), gt, out.dpv,
                    d_candi, tcfg.weight_var)
        return loss, out.dpv

    def train_step(state: TrainState, batch, bv_predict, bv_valid,
                   generator: Optional[torch.Generator] = None
                   ) -> TrainStepOutput:
        model = state.model
        dev = bv_predict.device
        d_candi = d_candis.get(dev)
        if d_candi is None:
            d_candi = d_candis[dev] = torch.as_tensor(cfg.d_candi, device=dev)
        lane_valid = [bool(v) for v in batch["lane_valid"]]
        scale = 1.0 / max(sum(lane_valid), 1)
        N, D = bv_predict.shape[:2]
        poses = batch["poses"]
        if tcfg.pose_noise_level > 0:
            eps_r, eps_t = draw_pose_noise(poses, generator)
            poses = apply_pose_noise(poses, eps_r, eps_t,
                                     tcfg.pose_noise_level)
        lanes = dict(batch, poses=poses)
        with step_numerics(False), deterministic_backward():
            state.optimizer.zero_grad(set_to_none=False)
            loss = torch.zeros((), device=dev)
            dpvs = []
            for n in range(N):
                if not lane_valid[n]:
                    dpvs.append(torch.full(bv_predict.shape[1:], -math.log(D),
                                           device=dev))
                    continue
                lane, dpv = lane_loss(model, lanes, n, d_candi, bv_predict,
                                      bool(bv_valid[n]))
                (lane * scale).backward()
                loss = loss + lane.detach() * scale
                dpvs.append(dpv.detach())
            state.apply_gradients()
            # the prediction for the next frame, outside the graph, as the
            # reference's .detach(): TBPTT of length one
            # (train_utils/train_KVNet.py:155-171)
            dpvs = torch.stack(dpvs)
            with torch.no_grad():
                bv_next = predict_next(dpvs, batch["pose_next"], batch["K"],
                                       d_candi, kernels)
                depth_low = depth_regression(dpvs, d_candi)
        return TrainStepOutput(state, loss, bv_next, depth_low)

    return train_step

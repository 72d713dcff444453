#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each printing its own lines:

1. the device: fail without CUDA; print the card's name and power limit;
2. build every kernel from ``neuralrgbd_tpu_torch/csrc`` (nvcc, sm_90a),
   printing ``ptxas``'s registers and shared memory for each;
3. the sweep kernel against its plain twin at the operating point
   (V=4, D=64, 64x96, C=67), translation poses and 5 deg of roll per view,
   L2 and L1, on channels-last features and on channel-planar ones seen
   through strides (the layout ``KVNet`` hands it);
4. the prediction kernel (pose inverse, coordinates, faces, trilinear
   sample and clamp for all lanes in one launch) against its plain twin at
   (64, 64, 96) with N=1 and N=2 (each lane its own pose and K; each lane
   of the N=2 launch bit for bit what it gives alone), and at the wide
   shapes (64, 64, 192) and (64, 256, 384), under four poses: the
   synthetic pose_next, 3 and 5 deg of roll, and a translation that puts
   part of the next frustum behind the current camera; and the
   single-lane entry ``resample_dpv_cuda``;
5. a T=8 rollout of the KV-Net at 384x256 (D=64, 4 source views,
   feature_dim 64, fp32, exact reference semantics) with seeded weights:
   finite outputs, log-DPVs <= 0 that sum to 1 over D, depth in
   [d_min, d_max], confidence in (0, 1], and every kernel's launch count
   equal to T (``conv3d_f32``'s, the exact K-Net's, 23 x (T - 1): frame
   0 has no K-Net); then one step of two lanes: two sweep launches and
   one resample launch;
6. the same rollout on the plain versions on the card, and its first two
   frames on the CPU, against phase 5;
7. timings: ms per frame on both paths (CUDA events), and each kernel at
   the operating-point shapes beside its plain twin: ``device_ms`` (a CUDA
   graph of 100 launches replayed between events), ``call_ms`` (events
   around 20 calls from Python), ``host_us`` (host time to issue one
   call); ``predict_next`` as the step calls it at N=1 and N=2 on both
   paths (host clock ending in a sync); ``F.grid_sample``'s 5-D call on a
   pre-faced volume and grid; and one frame under torch.profiler, its 15
   costliest ops by device time printed;
8. the conv kernel against its plain twin at the K-Net layer shape
   (64, 64, 96, 64) -> 64 and at the coarse-D K-Net's (32, 64, 96, 64)
   (bf16 output with the BatchNorm sums, and the fp32 output),
   ``conv3d_dma`` at C=N=16 and W=100, and the gradients of
   ``conv3d_3x3x3`` against autograd through the plain conv;
9. ``sweep_cost_volume_l2`` on the card: the fused sweep kernel, bit for bit;
10. the T=8 rollout with ``fast_knet=True`` (the K-Net's ten 64->64 convs on
   the conv kernel): phase 5's checks, the conv kernel launched 10 x (T-1)
   times (frame 0 skips the K-Net), the same rollout on the plain twins, and
   both held against phase 5's exact path to the JAX flag's class (mean
   |depth difference| < 0.05 m);
11. timings of the fast path: ms per frame beside the exact path; the conv
   kernel per layer on pre-packed weights, as the rollout calls it (the
   packed-weight cache of ``knet_fast_apply``) and through the wrapper on
   unpacked weights (packing on every call), each beside its plain twin,
   cuDNN's bf16 conv3d and its bound, with its TFLOP/s and share of the
   bound; the ten-layer chain, the whole K-Net, and the resample at W=192
   and 384;
12. host syncs: ``predict_next`` as the kernel-path step calls it, run
   under ``torch.cuda.set_sync_debug_mode("warn")``, must not sync; every
   sync of one whole kernel-path step is printed with its place in the
   code;
13. the step's numerics (``infer.step.step_numerics``): T=4 rollouts with
   the global TF32 flags off, at PyTorch's defaults (cuDNN's on), all on,
   off again and at the defaults again, ``cudnn.deterministic`` left at
   PyTorch's default (this script never sets it): all five equal bit for
   bit (the step sets TF32 off and deterministic cuDNN algorithms for
   itself), and after each the flags read as the caller left them. Also
   printed: the size of the TF32 deviation (``tf32=True``), ms per frame
   of the step beside the same step with cuDNN's default algorithm choice,
   and the step's ops that have no deterministic implementation;
14. the production loop: a 40-frame ``write_plane_scene`` (640x480) on disk,
   phase 5's weights saved as a reference-style ``.tar``, and the port's
   ``cli.test_kvnet.main`` on them at the operating point on the card: the
   export contract (35 frames, every file, ``scene_path_info.txt``), depth
   in [d_min, d_max] and confidence <= 1 in the pgm units, 35 launches of
   the sweep and the resample kernels; the loop's ms per frame (frames 2
   on; CUDA events after each step, whose intervals are the frame period
   the card sees) beside the rollout's, in turns (loop, rollout, loop,
   rollout, loop, rollout), the host time of each step call and of the
   main thread between steps, and the decode and export threads' times;
   all 35 frames' maps equal ``_q16`` of ``make_rollout`` on the same
   windows, and equal from one loop run to the next; and the main
   thread's host syncs per frame in one more loop run;
15. ``cli.evaluate`` on the same scene and checkpoint: one JSON line with
   finite metrics and n_valid > 0 (the weights are random: no accuracy
   threshold);
16. cached features: a T=8 ``make_rollout(cache_features=True)`` on the
   first 8 sliding windows of phase 14's scene, kernel path (phase 5's
   checks) and plain twins (within phase 6's 1e-2); equal bit for bit to
   a stepwise oracle that featurizes every window frame fresh; the
   extractor called for window 0's 4 frames and then once per step; then
   ``cli.test_kvnet --cache_features`` on the scene: its launches, the
   export contract and all 35 frames' maps equal to the cached rollout's
   on the same windows;
17. the coarse-D K-Net (``coarse_knet=2``): T=8 rollouts on the exact and
   the ``fast_knet`` path (phase 5's checks; the conv kernel launched
   10 x (T-1) times, all at D=32), frame 0 equal bit for bit to phase 5's
   exact path, kernel vs plain path (max 1e-2 exact; mean 1e-2 fast, its
   convs in bf16), the deviation from the exact path printed, the conv
   kernel timed at (32, 64, 96, 64), and ``cli.test_kvnet --knet_coarse_d
   2``: launches, contract, maps equal to the coarse rollout's;
18. bf16 convs (``dtype="bfloat16"``): a T=8 rollout (phase 5's checks),
   kernel vs plain path within a 1e-2 m mean, and within a 0.05 m mean of
   phase 5's fp32 exact path; then ms per frame of every path (exact,
   cached, coarse-D, ``fast_knet``, coarse-D with ``fast_knet``, bf16, and
   bf16 with its weights cast on every call, and all three flags) on
   phase 14's windows, in turns, with the card's name and power limit;
   and the feature extractor alone (5 frames and 1; fp32 on the D-Net conv
   kernel and on cuDNN, and bf16), ms and kernel launches per call.

19. training at the operating point (``train.step.make_train_step``,
   fp32, TF32 off, Adam at lr 1e-4): 8 steps overfitting one window (the
   loss falls; the carry on the resample kernel once a step, no sweep
   kernel: the forward trains on the plain ops), a 2-lane step with the
   carry on the kernel against one with it on the plain ops (the loss
   bit for bit, the carry within the resample tolerance), one step's
   gradients on the card against the CPU at 96x64 D=8, two identical
   4-step runs equal bit for bit in every parameter, loss and carry (the
   guard of ROADMAP C2), the bisection that found C2 (each probe run
   twice on fixed inputs: a whole step before the repair, with cuDNN
   disabled and in a fresh process with CUBLAS_WORKSPACE_CONFIG set; each
   module's backward; BatchNorm with and without cuDNN; the two repaired
   backwards), the fp32 step's ms with and without the repair at 1 and 2
   lanes in turns, ms per step, host ms and peak memory for 1 and 2
   lanes in fp32 and bf16, host syncs per step, and ``cli.train_kvnet``
   for 3 steps on phase 14's scene followed by ``cli.test_kvnet
   --model_path`` on the checkpoint it wrote;
20. KITTI at no-crop: a fabricated 30-frame drive at 1242x375 through
   ``cli.test_kvnet --dataset kitti --crop_w 768`` at 768x256 (the sweep
   at 64x192 and the resample at W=192 against their twins, launches,
   the contract, ms per frame, the loop against the rollout), and 2
   train steps on its labelled windows;
21. the pose-free LBA pipeline at the operating point (20 iterations x 3
   scales): the resample kernel at (64, 256, 384), as ``make_lba_maps``
   calls it, bit for bit against its twin; the LBA program (V=4) on a
   smooth recovery problem on the card against the CPU (and the error
   shrinking), the CLI's program twice bit for bit, its ms and kernel
   launches per frame; ``cli.test_kvnet_lba`` on a 24-frame capture
   (``write_scannet_scene`` frames, a ``.json`` intrinsics file, a DSO
   ``result.txt`` from its poses at a monocular scale) through the host
   and the device pose-graph arms: the contract and ``poses.npz``, one
   sweep, one prediction and one image-resolution resample launch per
   frame, ``--timing``'s stages, the device arm against the host arm at
   the chaos floor, and the host syncs per steady device-arm frame;
22. the remaining heads (DGF, ``refine_costv``, ``dnet_bayes``,
   ``refine_dup``), each a ``KVNet`` at the operating point on seeded
   weights: a T=8 kernel-path rollout (phase 5's checks; DGF's depth is
   the guided filter's, bounded by 0 only; one sweep and one resample
   launch a frame), the same again bit for bit, the plain path within
   phase 6's 1e-2 (max and mean printed), 0 host syncs in a steady step
   and the rollout's peak memory; DGF on the card vs the CPU over 2
   frames (depth max and mean); ``refine_costv`` with ``fast_knet`` (the
   conv kernel 10 x (T-1) times, within 0.05 m mean of its exact path);
   ms per frame of every head beside the default head, in turns; one
   R-Net pass, default and ``refine_dup``, against its fp32 bound;
   ``cli.test_kvnet --refine_net DGF`` on phase 14's scene from a
   reference-style ``.tar`` (launches, contract, maps equal to the DGF
   rollout's); 3 train steps at 1 lane, fp32, with a valid carry under
   ``refine_dup`` (on the up4 labels), ``dnet_bayes`` and
   ``refine_costv``, twice: the loss finite and falling, the runs equal
   bit for bit, ms per step and peak memory; ``cli.train_kvnet
   --refine_dup`` for 2 steps; and the six legacy refine heads on the
   card vs the CPU (same weights, fp32) at the DPV grid, with their ms;
23. lockstep trajectories on one card (``infer.loop.
   run_trajectories_parallel``): three ``write_plane_scene``s of 24, 20
   and 16 frames, the second with a non-finite pose at its frame 9: the
   per-lane counts (the valid windows), one step call per lockstep frame
   with N sweep launches for its N active lanes and 1 prediction launch,
   each lane's maps and images equal bit for bit to its own
   ``run_trajectory`` (the same frames in ``scene_path_info.txt``,
   numbered by JAX's two conventions, under JAX's lockstep header), a second run equal to the first,
   0 main-thread host syncs, ``cli.test_kvnet --multi_device --traj_idx 0
   1`` on phase 14's ``.tar`` equal to the function's lanes, its
   ``mesh=None`` printed and 1 device on this one card (JAX's rule,
   ``parallel.lane_mesh``; ``lockstep_cards.py`` runs it on 4); then ms per
   lockstep frame at N = 1, 2 and 4 equal 12-frame lanes against N single
   runs, in turns, twice (CUDA events after each step);
24. data-parallel training (``parallel.make_sharded_train_step``) through
   ``dryrun_dp_torch.certify``: 2 ``gloo`` ranks of one lane each, both
   processes on the one card, against the one-process 2-lane step on the
   same batch at the operating point: the loss within rel 1e-4, the
   parameters within 3 lr, the summed gradient within rel 1e-5, the
   carry's losses within rel 1e-3 (and whether bit for bit), both ranks'
   final parameters equal, the 3-step carry's loss falling, one prediction
   launch per step per rank, each rank's ms per step and peak memory.
   A rank that fails to start or run fails the phase;
25. the training campaign (``tools.train_campaign.run --wide``) at the
   operating point: 3 ``mixed3`` training scenes and the 3 holdouts (one
   per kind) of 12 frames, 20 steps, a holdout evaluation at steps 0, 10
   and 20 and after training, each new best abs_rel checkpointed (the
   first at step 10): the loss and every evaluation finite; one sweep and
   one resample launch per holdout frame and one resample per train step;
   every best checkpoint and the last restored into a fresh ``TrainState``
   equal, bit for bit, to the state each saved (weights, Adam's moments
   and step, the count), and one train step on the same batch from the
   step-10 state and from its restored copy equal; ms per step; then
   ``tools.eval_deviations.gate`` on the best checkpoint: its five arms
   (exact, cached, coarse, deploy, bf16) finite, the exact arm equal to
   the campaign's step-10 evaluation, one sweep and one resample per
   frame of each arm;
26. the campaign's ``--mesh`` arm (``tools.train_campaign --mesh
   --wide``) at JAX's reduced point (D=32, feature_dim 32, 128x96, 8
   ``plane`` scenes and 2 holdouts of 16 frames, 8 lanes a step): the
   sweep kernel against its twin at D=32, C=35 on the 32x24 grid (two
   poses) and the prediction kernel at (32, 24, 32) under the four poses,
   one lane each and all four in one launch; then, through
   ``dryrun_dp_torch.certify_campaign``, 2 ``gloo`` ranks of 4 lanes, both
   processes on the one card (rank 0 writing the scenes, evaluating and
   checkpointing), for 6 steps with an evaluation every 3, against one
   process at 8 lanes on the same scenes: the DP certificate (the first
   loss within rel 1e-4, its summed gradient within rel 1e-5, the later
   losses within rel 1e-3, the parameters after step 1 within 0.05 lr),
   both ranks' final parameters equal, rank 0's abs_rel within 1e-3 of the one
   process's at each evaluation; one prediction launch per step per rank
   and one sweep and one prediction per holdout frame on rank 0; each
   rank's ms per step and peak memory;
27. the compiled programs (``infer.graph.StepGraph``: the step captured
   in a CUDA graph per key and replayed per frame; phases 14, 16, 17, 20,
   22 and 23 already run the loop graphed, its default at ``chunk_t >
   1``): T=8 rollouts with ``graph=True`` equal bit for bit to the eager
   ones on the exact, cached and ``fast_knet`` paths and the four heads
   of phase 22, their kernels counted through the replays, the graphs
   captured, their capture times and the peak memory of both;
   ``cli.test_kvnet`` at ``--chunk_t 32`` (graphed) against ``--chunk_t
   1`` (eager): every file equal, 35 sweep and 35 prediction launches
   through the replays; 0 main-thread host syncs in the steady graphed
   frames (after the 2 captures); phase 23's graphed lockstep lanes equal
   the eager lockstep run's; and ms per frame of the loop graphed against
   eager (``chunk_t`` 32 both), three turns each, with the host ms per
   step call, the run's wall time, the graphs, the capture ms per key and
   the peak memory. Alone it writes phase 14's scene and checkpoint and
   phase 23's lanes itself;
28. the compiled train and LBA programs (``make_train_step(graph=True)``,
   ``make_lba_program(graph=True)``, the LBA CLI's graphed frames): 4
   train steps graphed against 4 eager ones under the ``--wide``
   campaign's clip and pose noise, bit for bit (losses, carries, depth
   maps, parameters, gradients, Adam's moments), at 1 and 2 lanes fp32,
   1 lane bf16 and ``refine_dup``, the gradients kept in their tensors,
   one prediction launch a step through the replays, the keys and the
   clip captured; ms per step graphed and eager in turns, the host ms per
   step call, the capture ms per key, the peak memory; phase 24's 2-rank
   DP step graphed, its losses equal to phase 24's eager ones; the
   campaign's 4-step self-check graphed by its default; the LBA program
   graphed against eager (the capture and a replay) and ms per frame;
   ``cli.test_kvnet_lba --graph`` on both pose-graph arms against phase
   21's eager runs: every file equal (``poses.npz`` NaN equal), B1 once
   and B2 and B3 once each a frame through the replays, the TIMING lines;
   0 host syncs per steady graphed device-arm frame. Alone it writes its
   scene and checkpoint and runs phases 21's and 24's eager arms itself;
29. the D-Net's fp32 conv kernel (``ops.cuda.conv2d_bn``) at the feature
   extractor's shapes, on phase 5's first window (5, 3, 256, 384) and its
   last frame alone (1, 3, 256, 384): every launch of one kernel-path call
   (57 convs, 56 finalizes, 25 residual adds) held against its plain twin
   run in fp64 on the same inputs (``CONV2D_TOL``), the chain going on from
   the kernels' outputs; the launches counted; two calls and the held one
   equal bit for bit; the gap to cuDNN's fp32 modules printed; and the
   extractor's device ms on the kernel path (a CUDA graph of 5 calls),
   call ms and host us a call, beside its twins on the card, cuDNN fp32
   (the modules in the step's numerics) and the convs' bound;
30. the exact K-Net's conv kernel (``ops.cuda.conv3d_f32``) at its layer
   shapes in both benchmark cells, (64, 64, 96) and (64, 64, 192) with 64
   channels: the split pass bit for bit against its twin (a pending
   BatchNorm and ReLU, a pending BatchNorm and a skip, the K-Net's input
   read in place); the 16 -> 64 and 64 -> 64 convs and the head (64 -> 1)
   against fp64 convs of the same inputs, each within ``KNET_F32_BAR``
   (2x) of cuDNN fp32's own distance, a bar that one TF32 product misses;
   the BatchNorm each conv leaves pending against the fp64 batch
   statistics; two calls equal bit for bit; and the 64 -> 64 conv's device
   ms, call ms and host us beside its plain twin, cuDNN fp32's conv, its
   3xTF32 bound and its fp32 FFMA bound, with the split's and the head's
   device ms.

Every phase that counts launches also expects the D-Net conv kernel's,
``FE_LAUNCHES`` (138) a kernel-path extractor call: one a lane-step of an
fp32 inference step, one a frame featurized on the cached path, none in
training or with a bf16 extractor; and the exact K-Net's,
``KNET_F32_LAUNCHES`` (23: 11 splits, 11 convs, the head) a K-Net call:
one a lane-step of an fp32 inference step with a valid carry, none on the
fast path, with bf16 convs, under ``dnet_bayes`` or in training.

Then one ``{"kernels": [...]}`` line (the conv kernel's launches: phase
10's, phase 17's, phase 22's and phase 27's fast path; the sweep's, the
resample's, the D-Net conv kernel's and the exact K-Net's: phase 5's and
phases 19-28's, phase 24's, 26's and 28's DP counted in the rank
processes (the sweep's and the resample's), phases 27's and 28's through
the graphs' replays; the D-Net conv kernel's row is
phase 29's, at five frames, with one frame's under ``n1``; the K-Net
conv kernel's row is phase 30's 64 -> 64 conv at (64, 64, 96), KITTI's
width under ``w192``, and its error the largest distance to fp64 there)
and, last, the ``{"ok": true, ...}`` line. Any failed check exits non-zero before those two lines. A kernel's
``ms`` in that line is its ``device_ms``. Every
kernel's ``bound_ms`` is computed here from the shapes it was timed at:
the larger of its bytes (each input read once, each output written once)
over 3.35 TB/s and its operations over the card's peak for their type
(989 TFLOP/s bf16 and 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s
fp32; ``conv3d_f32`` takes three TF32 products a multiply-add).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from neuralrgbd_tpu_torch.cli import evaluate as cli_evaluate
from neuralrgbd_tpu_torch.cli import test_kvnet_lba as cli_lba
from neuralrgbd_tpu_torch.cli import test_kvnet as cli_test_kvnet
from neuralrgbd_tpu_torch.cli import train_kvnet as cli_train_kvnet
from neuralrgbd_tpu_torch.config import ModelConfig, TrainConfig
from neuralrgbd_tpu_torch.data import kitti
from neuralrgbd_tpu_torch.data.scannet import make_trajectory
from neuralrgbd_tpu_torch.data.synthetic import (synthetic_batch,
                                                 write_plane_scene,
                                                 write_scannet_scene)
from neuralrgbd_tpu_torch.data.trajectory import window_batch
from neuralrgbd_tpu_torch.infer import graph as graph_mod
from neuralrgbd_tpu_torch.infer import loop as loop_mod
from neuralrgbd_tpu_torch.infer import rollout as rollout_mod
from neuralrgbd_tpu_torch.infer import step as step_mod
from neuralrgbd_tpu_torch.infer.export import read_pgm
from neuralrgbd_tpu_torch.infer.rollout import make_rollout
from neuralrgbd_tpu_torch.infer.step import (make_frame_features,
                                             make_infer_step, predict_next)
from neuralrgbd_tpu_torch.models import layers as layers_mod
from neuralrgbd_tpu_torch.models.feature_extractor import FeatureExtractor
from neuralrgbd_tpu_torch.models import refine_legacy as legacy
from neuralrgbd_tpu_torch.models.kvnet import KVNet
from neuralrgbd_tpu_torch.models.rnet import RNet
from neuralrgbd_tpu_torch.ops.camera import Camera, camera_from_K
from neuralrgbd_tpu_torch.ops.cuda import build
from neuralrgbd_tpu_torch.ops.cuda import conv2d_bn as kconv2d
from neuralrgbd_tpu_torch.ops.cuda import conv3d as kconv
from neuralrgbd_tpu_torch.ops.cuda import conv3d_f32 as kconv3d_f32
from neuralrgbd_tpu_torch.ops.cuda import resample as kresample
from neuralrgbd_tpu_torch.ops.cuda import conv3d_pair as kpair
from neuralrgbd_tpu_torch.ops.cuda import sweep_fused as ksweep
from neuralrgbd_tpu_torch.ops.cuda.conv3d_dma import conv3d_dma
from neuralrgbd_tpu_torch.ops.cuda.conv3d_pair import (_layer, knet_fast_apply,
                                                       packed_weights)
from neuralrgbd_tpu_torch.ops.cuda.sweep import sweep_cost_volume_l2
from neuralrgbd_tpu_torch.ops import sampling
from neuralrgbd_tpu_torch.ops.dpv import _set_vol_border, uniform_dpv
from neuralrgbd_tpu_torch.ops.rotations import rotation_to_quat
from neuralrgbd_tpu_torch.ops.sampling import _pixel_to_normalized
from neuralrgbd_tpu_torch.ops.sweep import (_sweep_pixel_coords,
                                            backward_warp_by_depth)
from neuralrgbd_tpu_torch.parallel.mesh import lane_mesh
from neuralrgbd_tpu_torch.pose.lba import make_lba_program
from neuralrgbd_tpu_torch.train import step as train_step_mod
from neuralrgbd_tpu_torch.train.loop import upload_batch
from neuralrgbd_tpu_torch.train.loss import nll_dpv_loss
from neuralrgbd_tpu_torch.train.step import (create_train_state,
                                             make_train_step)
from neuralrgbd_tpu_torch.tools import eval_deviations, train_campaign
from neuralrgbd_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   restore_params_partial)
from neuralrgbd_tpu_torch.utils.timing import (call_ms, device_ms, host_ms,
                                               host_us)

CFG = ModelConfig()          # feature_dim 64, D=64, t_win_r=2, fp32, exact
IMG_HW = (256, 384)
T = 8
SEED = 0
KERNELS = {"sweep_fused": ksweep, "resample": kresample, "conv3d": kconv,
           "conv2d_bn": kconv2d, "conv3d_f32": kconv3d_f32}
# Kernel vs plain twin: the twins go through F.grid_sample, which maps pixel
# coords to [-1, 1] and back; at widths up to 384 px that moves a coordinate
# by ~1e-4 px, i.e. ~1e-4 in O(1) sampled values. The prediction kernel's
# twin takes the same 8 taps at the pixel coordinates, without that round
# trip, and the kernel rounds the inverse, the coordinates and the tap sum
# product by product as the twin's torch ops do (no FMA contraction), so
# they agree to the last bit unless a torch op rounds otherwise; the
# resample keeps the grid_sample standard all the same.
TOL = {"cost": (1e-4, 1e-3), "kept": (1e-4, 5e-4), "resample": (1e-4, 5e-4)}
# Kernel path vs plain path through 8 recurrent frames (depth in m).
ROLLOUT_TOL = {"depth": 1e-2, "confidence": 1e-2}
# ... except DGF's depth, held by its mean |difference| in m (its max is
# printed): the guided filter divides by var_x + 1e-8 over 3x3 windows of
# a learned guide, and where the guide is flat it amplifies the ~1e-4 m
# by which the sweep kernel and F.grid_sample differ (on the CPU, JAX's own
# float32 and float64 DGF heads lie 4.4 m apart on a smooth image,
# tests/test_torch_heads.py). Its confidence, the low-res posterior's,
# keeps the 1e-2 max.
DGF_DEPTH_MEAN = 1e-3
# Conv kernel vs plain twin: both sum exact bf16 products in fp32, in
# another order (and cuDNN's fp32 algorithm may round its own way), so the
# fp32 outputs differ by ~1e-5 on O(1) values; a bf16 output then differs
# by at most one bf16 ulp where a sum lands on the other side of a rounding
# boundary (2^-7 relative). Statistics: rtol 1e-4 of the sum of |terms|.
CONV_TOL = {"fp32": (1e-5, 1e-4), "bf16": (8e-3, 1e-5), "stats": 1e-4,
            "grad": (1e-5, 1e-5)}
# The fast K-Net path (bf16 convs) vs the exact path, and the kernel vs the
# plain twins on the fast path: the class of the JAX flag's own test
# (tests/test_pallas_conv_pair.py:130), mean |depth difference| in m.
# Also the bf16 path (dtype="bfloat16") vs the fp32 exact path.
FAST_DEPTH_MEAN = 0.05
# Kernel path vs plain path where convs run in bf16 (the fast coarse-D
# K-Net, dtype="bfloat16"): a one-ulp rounding flip feeds the next layer's
# sums and flips more (tests/test_torch_deviations.py measured it), so a
# pixel near a tie can move far; the mean |depth difference| in m holds.
BF16_ROLLOUT_MEAN = 1e-2
BF16 = dataclasses.replace(CFG, dtype="bfloat16")
# The D-Net's fp32 conv kernel (ops.cuda.conv2d_bn) against its plain twins
# run in fp64 on the same inputs, at the extractor's own shapes (phase 29):
# each conv within 1e-4 of the sum of its |terms| (fp32 sums of up to 2880
# products, in another order); each tile's mean and M2 within 1e-4 of the
# tile's mean |y| and sum of y^2; the finalize's mean within 1e-4 of |mean|
# + std and its scale within rtol 1e-4, against the batch's statistics of
# the kernel's output; the residual add within 1e-5 of the magnitudes it
# sums (|raw - mean| * |scale| + |beta| of each side). A wrong tap, a BatchNorm applied at the wrong place or a pad
# of a(0) instead of 0 misses by 1e-2 and more.
CONV2D_TOL = {"conv": 1e-4, "stats": 1e-4, "finalize": 1e-4,
              "residual": 1e-5}
KNET_LAYER = (CFG.ndepth, IMG_HW[0] // 4, IMG_HW[1] // 4, CFG.kv_feature_dim)
# the coarse-D K-Net's layer (knet_coarse_d = 2): D/2 planes
KNET_LAYER_D32 = (CFG.ndepth // 2, *KNET_LAYER[1:])
# Published peaks of one H100 SXM (dense) and its memory rate.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# PyTorch's own TF32 switches (cuDNN, cuBLAS), read before phase 1 sets both
# off for the whole script
TORCH_TF32_DEFAULTS = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
# and its cuDNN algorithm choice, which this script never sets: the step
# sets deterministic algorithms for itself (phase 13)
TORCH_DETERMINISTIC_DEFAULT = torch.backends.cudnn.deterministic
# Phase 14's scene: T_LOOP refs of a 40-frame trajectory (t_win_r = 2)
SCENE_FRAMES = 40
T_LOOP = SCENE_FRAMES - 2 * CFG.t_win_r - 1
CARD: list[str] = []      # nvidia-smi's "name, power.limit", from phase 1
# Phase 19: training at the operating point with Adam at the JAX tests' LR
TRAIN = TrainConfig(lr=1e-4)
TRAIN_STEPS = 8           # the overfit steps on one window
# One train step on the card vs the same step on the CPU, at the JAX step
# tests' size: per tensor, max |difference| over the tensor's max |g|. The
# feature extractor within 5e-2: its ReLUs after batch-statistics
# BatchNorm have kinks, and an activation within fp32 rounding of 0 takes
# the other branch on one of the two devices (tests/test_torch_train.py
# measured 3% against JAX on the CPU, and agreement to 1e-6 in float64).
# The K-Net (the same ReLUs after BatchNorm) within 5e-3: it read 1.45e-3
# on an H100. The R-Net (leaky ReLUs, no BatchNorm) within 1e-3.
SMALL = ModelConfig(feature_dim=16, kv_feature_dim=16, ndepth=8, d_min=0.5,
                    d_max=4.0)
SMALL_HW = (64, 96)
GRAD_TOL = {"feature_extractor": 5e-2, "kv_net": 5e-3, "r_net": 1e-3}
# Phase 20: a fabricated KITTI drive (1242x375 on disk), read at no-crop
# 768x256 (a 192x64 DPV grid), KITTI's depth range
KITTI_CFG = dataclasses.replace(CFG, d_min=1.0, d_max=60.0)
KITTI_WH = (768, 256)
# Phase 30: the exact K-Net's conv kernel (ops.cuda.conv3d_f32) at its
# layer shapes in both benchmark cells (ScanNet's 64x96 DPV grid, KITTI's
# 64x192), against fp64: each conv and the head no further from an fp64
# conv of the same input than KNET_F32_BAR times cuDNN fp32's own distance
# (the tests' bar), which one TF32 product (both operands rounded to TF32,
# summed in fp32) must miss
KNET_F32_SHAPES = (KNET_LAYER, (CFG.ndepth, KITTI_WH[1] // 4,
                                KITTI_WH[0] // 4, CFG.kv_feature_dim))
KNET_F32_BAR = 2.0
KITTI_FRAMES = 30         # 20 after the first and last 5; 15 windows
T_KITTI = KITTI_FRAMES - 10 - 2 * CFG.t_win_r - 1
# Phase 21: the LBA CLI on a 24-frame capture (19 exported frames), DSO's
# translations at a monocular scale of 7, the reference's 20 iterations
LBA_FRAMES, LBA_DSO_SCALE, LBA_ITERS = 24, 7.0, 20
SYNC_FRAMES = 6           # steady frames between the two sync-count runs
# Phase 22: the remaining heads (``KVNet``'s, at the operating point)
HEADS = {"DGF": dict(refine_net="DGF"), "refine_costv": dict(refine_costv=True),
         "dnet_bayes": dict(dnet_bayes=True), "refine_dup": dict(refine_dup=True)}
TRAIN_HEAD_STEPS = 3
# The legacy refine heads, card vs CPU on the same weights: fp32 sums in
# another order (cuDNN and oneDNN) through up to 10 layers with batch-
# statistics BatchNorm; max |difference| over the output's max |value|.
LEGACY_TOL = 1e-4
# Phase 23: lockstep lanes (``run_trajectories_parallel``) on one card. The
# lanes' scenes are ragged, so lanes drop out; lane 1's frame 9 gets a
# non-finite pose, so its lane skips 5 windows and resets its carry. The
# timing lanes are equal (7 lockstep frames each), at N of them.
LOCK_FRAMES = (24, 20, 16)
LOCK_INVALID = (1, 9)
TIME_FRAMES = 12
TIME_LANES = (1, 2, 4)
# Phase 25: a short --wide campaign (3 mixed3 training scenes and the 3
# holdouts, one per kind, of CAMP_FRAMES frames), an evaluation every
# CAMP_EVAL steps, the first of them checkpointed as the best
CAMP_SCENES, CAMP_FRAMES, CAMP_STEPS, CAMP_EVAL = 3, 12, 20, 10
# phase 26: the --mesh campaign's steps and evaluation interval
MESH_STEPS, MESH_EVAL = 6, 3
# Phase 28: the compiled train step under the --wide campaign's clip and
# pose noise (both graphs, and the noise drawn outside them), in these
# configurations, each 4 steps graphed against 4 eager
TRAIN_GRAPH = dataclasses.replace(TRAIN, grad_clip_max=2.0,
                                  pose_noise_level=0.02)
GRAPH_TRAIN_CASES = (("fp32, 1 lane", CFG, 1), ("fp32, 2 lanes", CFG, 2),
                     ("bf16, 1 lane", BF16, 1),
                     ("refine_dup, 1 lane",
                      dataclasses.replace(CFG, refine_dup=True), 1))
DP_RUNS: dict = {}        # phase 24's certificate, which phase 28 reads

failures: list[str] = []


def fe_launches(fe: FeatureExtractor) -> int:
    """The conv kernel's launches in one kernel-path call of the feature
    extractor ``fe`` (``FeatureExtractor.fused``): a conv each, a finalize
    each conv but the last, a residual add each block."""
    blocks = [b for layer in (fe.layer1, fe.layer2, fe.layer3, fe.layer4)
              for b in layer]
    convs = 3 + sum(2 + (b.downsample is not None) for b in blocks) + 2
    return convs + (convs - 1) + len(blocks)


FE_LAUNCHES = fe_launches(FeatureExtractor(CFG.feature_dim, device="meta"))
# conv3d_f32's launches in one exact K-Net call: 11 splits, 11 convs (each
# with its finalize) and the head
KNET_F32_LAUNCHES = 23


def knet_steps(steps: int, cfg=CFG, fast_knet: bool = False) -> int:
    """The exact K-Net's calls on ``conv3d_f32`` in ``steps`` inference
    steps with a valid carry: one each, none on the fast path (B4), with
    bf16 convs (the modules) or under ``dnet_bayes`` (no K-Net)."""
    exact = not fast_knet and cfg.dtype == "float32" and not cfg.dnet_bayes
    return steps if exact else 0


def expected_launches(sweeps: int, resamples: int, conv3d: int = 0,
                      extractor: int | None = None, knet: int = 0) -> dict:
    """Each kernel's launches in a run of ``sweeps`` sweeps, ``resamples``
    predictions, ``conv3d`` K-Net convs on the bf16 path, ``extractor``
    kernel-path feature-extractor calls and ``knet`` exact K-Net calls on
    the fp32 kernels (``knet_steps``). ``extractor`` is ``sweeps`` by
    default: the fp32 inference step featurizes and sweeps once a lane
    (training runs neither kernel; a bf16 extractor and the cached path's
    calls differ)."""
    return {"sweep_fused": sweeps, "resample": resamples, "conv3d": conv3d,
            "conv2d_bn": FE_LAUNCHES * (sweeps if extractor is None
                                        else extractor),
            "conv3d_f32": KNET_F32_LAUNCHES * knet}


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        failures.append(what)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def within(got, want, rtol, atol) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def phase_device() -> torch.device:
    print("phase 1: device", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    CARD.append(smi.stdout.strip().splitlines()[0])
    print(CARD[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return torch.device("cuda", 0)


def phase_build() -> None:
    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    print(f"  built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Performance Loss")):
                print(f"  {name}: {line.strip()}", flush=True)
    print(f"  conv3d: {kconv.dynamic_smem_bytes()} bytes of dynamic shared "
          f"memory per block", flush=True)


def _K(h: int, w: int, wider: float = 0.0) -> np.ndarray:
    """synthetic_batch's intrinsics (60 x 48 deg fov, each ``wider`` deg
    wider) at an h x w grid."""
    return np.array(
        [[w / 2 / math.tan(math.radians(30 + wider / 2)), 0, w / 2],
         [0, h / 2 / math.tan(math.radians(24 + wider / 2)), h / 2],
         [0, 0, 1]], np.float32)


def _roll_poses(V: int, degrees: float, device) -> torch.Tensor:
    poses = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for v in range(V):
        a = math.radians(degrees * (v + 1))
        poses[v, :2, :2] = [[math.cos(a), -math.sin(a)],
                            [math.sin(a), math.cos(a)]]
        poses[v, :3, 3] = [0.04 * (v + 1), -0.02, 0.03]
    return torch.from_numpy(poses).to(device)


def sweep_args(device, poses, cfg=CFG, h=64, w=96):
    """(ref, srcs, Rs, ts, cam, d_candi) at V=4 and ``cfg``'s D and
    feature_dim + 3 channels on an h x w grid (D=64, 64x96, C=67)."""
    V, C = cfg.n_views, cfg.feature_dim + 3
    g = torch.Generator().manual_seed(SEED)
    ref = torch.randn(h, w, C, generator=g).to(device)
    srcs = torch.randn(V, h, w, C, generator=g).to(device)
    cam = camera_from_K(_K(h, w), device)
    d = torch.as_tensor(cfg.d_candi, device=device)
    return ref, srcs, poses[:, :3, :3], poses[:, :3, 3], cam, d


def sweep_inputs(device, poses, cfg=CFG, h=64, w=96):
    ref, srcs, Rs, ts, cam, d = sweep_args(device, poses, cfg, h, w)
    return ref, srcs, _sweep_pixel_coords(cam, Rs, ts, d, *ref.shape[:2])


def planar(t: torch.Tensor) -> torch.Tensor:
    """The same values stored channel-planar ((V,) C, H, W), seen through
    strides in the channels-last shape: what ``KVNet`` passes the sweep."""
    return t.movedim(-1, -3).contiguous().movedim(-3, -1)


def translation_poses(device) -> torch.Tensor:
    return torch.from_numpy(
        synthetic_batch(CFG, seed=SEED)[0]["poses"][0]).to(device)


def phase_sweep(device, errs) -> None:
    print("phase 3: sweep kernel vs plain twin at V=4 D=64 64x96 C=67",
          flush=True)
    for pose_name, poses in (("translation", translation_poses(device)),
                             ("roll 5 deg/view", _roll_poses(4, 5.0, device))):
        ref, srcs, coords = sweep_inputs(device, poses)
        for dist in ("L2", "L1"):
            pcost, pkept = ksweep.sweep_plain(ref, srcs, coords,
                                              CFG.sigma_soft_max, dist, 3)
            for layout, r, sr in (("channels-last", ref, srcs),
                                  ("planar", planar(ref), planar(srcs))):
                cost, kept = ksweep.sweep_kernel(r, sr, coords,
                                                 CFG.sigma_soft_max, dist, 3)
                torch.cuda.synchronize()
                e_cost, e_kept = max_err(cost, pcost), max_err(kept, pkept)
                errs.append(max(e_cost, e_kept))
                check(within(cost, pcost, *TOL["cost"])
                      and within(kept, pkept, *TOL["kept"]),
                      f"sweep {pose_name} {dist} {layout}: max|cost err| "
                      f"{e_cost:.3e} (|cost| <= "
                      f"{float(pcost.abs().max()):.1f}), max|kept err| "
                      f"{e_kept:.3e}")


def _pose_next(kind: str) -> np.ndarray:
    """A current-ref -> next-ref pose of phase 4."""
    pose = synthetic_batch(CFG, seed=SEED)[0]["pose_next"][0]
    if kind == "synthetic pose_next":
        return pose
    if kind.startswith("roll"):
        return pose @ _roll_poses(1, float(kind.split()[1]), "cpu")[0].numpy()
    # the next camera 1 m behind this one: its planes at d <= 1 m lie
    # behind the current camera (z <= 0, where the 1e-10 keeps z from 0)
    assert kind == "behind the camera"
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.05, -0.03, 1.0]
    return pose


POSES = ("synthetic pose_next", "roll 3 deg", "roll 5 deg",
         "behind the camera")


def resample_inputs(device, D, h, w, kinds=POSES[:1], seed=SEED, cfg=CFG):
    """(log-DPV (N, D, h, w), pose_next (N, 4, 4), K (N, 3, 3), d_candi
    of ``cfg``): one lane per pose kind, lane n with a fov 4n deg
    wider."""
    g = torch.Generator().manual_seed(seed)
    N = len(kinds)
    lv = torch.log_softmax(torch.randn(N, D, h, w, generator=g), 1)
    poses = np.stack([_pose_next(k) for k in kinds])
    Ks = np.stack([_K(h, w, 4 * n) for n in range(N)])
    return (lv.to(device), torch.from_numpy(poses).to(device),
            torch.from_numpy(Ks).to(device),
            torch.as_tensor(cfg.d_candi, device=device))


def phase_resample(device, errs) -> None:
    print("phase 4: prediction kernel vs plain twin", flush=True)
    pad = math.log(1.0 / CFG.ndepth)
    for shape in ((CFG.ndepth, 64, 96), (CFG.ndepth, 64, 192),
                  (CFG.ndepth, 256, 384)):
        for kind in POSES:
            args = resample_inputs(device, *shape, kinds=(kind,))
            got = kresample.predict_next_cuda(*args, pad)
            want = kresample.predict_next_plain(*args, pad)
            torch.cuda.synchronize()
            e = max_err(got, want)
            errs.append(e)
            check(within(got, want, *TOL["resample"]),
                  f"predict_next {shape} N=1, {kind}: max|err| {e:.3e}")
    for kinds in (POSES[:2], POSES[2:]):
        args = resample_inputs(device, CFG.ndepth, 64, 96, kinds)
        before = kresample.launches
        got = kresample.predict_next_cuda(*args, pad)
        launched = kresample.launches - before
        want = kresample.predict_next_plain(*args, pad)
        alone = [kresample.predict_next_cuda(*(a[n:n + 1] for a in args[:3]),
                                             args[3], pad) for n in range(2)]
        torch.cuda.synchronize()
        e = max_err(got, want)
        errs.append(e)
        check(launched == 1 and within(got, want, *TOL["resample"])
              and all(torch.equal(a[0], got[n]) for n, a in enumerate(alone)),
              f"predict_next (64, 64, 96) N=2 ({kinds[0]}; {kinds[1]}, fov "
              f"+4 deg): {launched} launch, max|err| {e:.3e}, each lane "
              f"equal to its N=1 launch")
    lv, poses, Ks, d = resample_inputs(device, CFG.ndepth, 64, 96, POSES[1:2])
    rel = torch.linalg.inv(poses[0])
    got = kresample.resample_dpv_cuda(lv[0], rel, Camera(K=Ks[0]), d, pad)
    want = kresample.resample_plain(lv, rel[None], Ks, d, False, pad)[0]
    torch.cuda.synchronize()
    e = max_err(got, want)
    errs.append(e)
    check(within(got, want, *TOL["resample"]),
          f"resample_dpv_cuda (64, 64, 96), roll 3 deg: max|err| {e:.3e}")


def frames_on(device, t_frames: int, n_lanes: int = 1):
    keys = ("ref", "srcs", "poses", "K", "pose_next")
    steps = [synthetic_batch(CFG, n_lanes=n_lanes, img_hw=IMG_HW,
                             seed=SEED + t)[0] for t in range(t_frames)]
    return {k: torch.from_numpy(np.stack([s[k] for s in steps])).to(device)
            for k in keys}


def bv0_on(device) -> torch.Tensor:
    return uniform_dpv(CFG.ndepth, IMG_HW[0] // 4, IMG_HW[1] // 4,
                       device)[None]


def check_rollout(model, frames, want_launches: dict, cfg=CFG, **kw):
    """Run the kernel-path rollout (``make_rollout(cfg, **kw)``) with the
    counts set to 0 just before and read just after; check the counts,
    shapes and value ranges, and the log-DPVs of one more step (outside
    the counted window)."""
    for mod in KERNELS.values():
        mod.launches = 0
    depth, conf, bv = make_rollout(cfg, **kw)(
        model, frames, bv0_on(frames["ref"].device), [False])
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    for name, n in launches.items():
        check(n == want_launches[name],
              f"{name} launched {n} times in {T} frames "
              f"(expected {want_launches[name]})")
    H, W = IMG_HW
    check(depth.shape == (T, 1, H, W) and conf.shape == (T, 1, H, W)
          and bv.shape == (1, CFG.ndepth, H // 4, W // 4), "output shapes")
    check(all(bool(torch.isfinite(x).all()) for x in (depth, conf, bv)),
          "depth, confidence and prediction are finite")
    dgf = cfg.refine_net == "DGF"
    if dgf:
        # the guided filter fits depth linearly to its learned guide, so
        # its output may leave the candidates' range: positive is the bound
        check(bool((depth > 0).all()),
              f"DGF depth > 0: [{float(depth.min()):.4f}, "
              f"{float(depth.max()):.4f}] (d_candi in [{CFG.d_min}, "
              f"{CFG.d_max}])")
    else:
        check(bool(((depth >= CFG.d_min - 1e-4)
                    & (depth <= CFG.d_max + 1e-4)).all()),
              f"depth in [{CFG.d_min}, {CFG.d_max}]: "
              f"[{float(depth.min()):.4f}, {float(depth.max()):.4f}]")
    check(bool(((conf > 0) & (conf <= 1 + 1e-6)).all()),
          f"confidence in (0, 1]: [{float(conf.min()):.4f}, "
          f"{float(conf.max()):.4f}]")
    check(bool(((bv <= 0) & (bv >= -1000)).all()),
          "prediction log-DPV in [-1000, 0]")
    step_kw = {k: v for k, v in kw.items() if k != "cache_features"}
    out = make_infer_step(cfg, **step_kw)(
        model, {k: v[-1] for k, v in frames.items()}, bv, [True])
    # DGF's refined field is the depth map, not a DPV
    for name in ("dpv",) if dgf else ("dpv", "dpv_refined"):
        lv = getattr(out, name)
        s = lv.exp().sum(1)
        check(bool((lv <= 0).all()) and max_err(s, torch.ones_like(s)) < 1e-4,
              f"{name} <= 0 and sums to 1 over D (max|sum-1| "
              f"{max_err(s, torch.ones_like(s)):.2e})")
    return launches, depth, conf


def phase_rollout(model, device) -> tuple:
    print(f"phase 5: kernel-path rollout, T={T} at {IMG_HW[1]}x{IMG_HW[0]}",
          flush=True)
    frames = frames_on(device, T)
    launches, depth, conf = check_rollout(
        model, frames, expected_launches(T, T, knet=T - 1))
    two = {k: v[0] for k, v in frames_on(device, 1, n_lanes=2).items()}
    before = {name: mod.launches for name, mod in KERNELS.items()}
    make_infer_step(CFG)(model, two, bv0_on(device).expand(2, -1, -1, -1),
                         [False, False])
    torch.cuda.synchronize()
    counts = {name: mod.launches - before[name]
              for name, mod in KERNELS.items()}
    check(counts == expected_launches(2, 1),
          f"one step of 2 lanes: launches {counts} (expected 2 sweeps, "
          f"1 resample for both lanes and the extractor's "
          f"{FE_LAUNCHES} conv2d_bn launches a lane; no K-Net on a first "
          f"frame)")
    return launches, frames, depth, conf


def phase_plain(model, device, frames, depth, conf) -> None:
    print("phase 6: plain-path rollout on the card, and 2 frames on the CPU",
          flush=True)
    pdepth, pconf, _ = make_rollout(CFG, kernels=False)(
        model, frames, bv0_on(device), [False])
    torch.cuda.synchronize()
    for name, got, want in (("depth", depth, pdepth),
                            ("confidence", conf, pconf)):
        e = max_err(got, want)
        check(e <= ROLLOUT_TOL[name],
              f"kernel path vs plain path, {name}: max|err| {e:.3e} over "
              f"{T} frames (mean {float((got - want).abs().mean()):.3e})")
    cpu_model = KVNet(CFG, device="cpu", single_refine=True)
    cpu_model.load_state_dict(model.state_dict())
    cdepth, cconf, _ = make_rollout(CFG)(
        cpu_model, {k: v[:2].cpu() for k, v in frames.items()},
        bv0_on("cpu"), [False])
    for name, got, want in (("depth", depth[:2].cpu(), cdepth),
                            ("confidence", conf[:2].cpu(), cconf)):
        e = max_err(got, want)
        check(e <= ROLLOUT_TOL[name],
              f"card vs CPU, first 2 frames, {name}: max|err| {e:.3e}")


def frame_ms(model, device, kernels: bool, fast_knet: bool = False,
             cfg=CFG) -> list[float]:
    """CUDA-event ms of frames 1..T-1 of a rollout (frame 0 skips the K-Net)."""
    frames = frames_on(device, T)
    step = make_infer_step(cfg, kernels=kernels, fast_knet=fast_knet)
    bv, valid, times = bv0_on(device), [False], []
    for t in range(T):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(model, {k: v[t] for k, v in frames.items()}, bv, valid)
        end.record()
        bv, valid = out.bv_predict, [True]
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times[1:]


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what sets it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[kind]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else \
        "operations"


def sweep_bound(ref, srcs, coords, keep: int) -> tuple[float, str]:
    """Inputs (ref, srcs, coords) read once, cost and kept RGB written once;
    11 fp32 flops per (view, depth, pixel, channel): 4 FMAs of bilinear
    interpolation, the difference, and the FMA of its square."""
    V, D, HW = coords.shape[:3]
    C = ref.shape[-1]
    nbytes = 4 * (ref.numel() + srcs.numel() + coords.numel()
                  + D * HW + V * D * HW * keep)
    return bound(nbytes, 11.0 * V * D * HW * C, "fp32")


def resample_bound(N, D, H, W) -> tuple[float, str]:
    """The prediction step's function: the log-DPV read once and the
    output written once (the matrices, K and d_candi are negligible);
    ~60 fp32 flops per voxel (the point and its coordinates ~25, the
    trilinear weights and 8 taps ~35)."""
    n = N * D * H * W
    return bound(4 * 2 * n, 60.0 * n, "fp32")


def conv_bound(shape, N: int, out_bytes: int, with_stats: bool
               ) -> tuple[float, str]:
    """bf16 x and w read once, the output (and the 2N fp32 sums) written
    once; 2 * 27 * C flops per output value on the bf16 tensor cores."""
    D, H, W, C = shape
    n = D * H * W
    nbytes = (2 * n * C + 2 * 27 * C * N + out_bytes * n * N
              + 8 * N * with_stats)
    return bound(nbytes, 2.0 * n * N * 27 * C, "bf16")


def phase_timing(model, device) -> dict:
    print("phase 7: timing", flush=True)
    runs = {True: [], False: []}
    for kernels in (False, True, True, False):
        times = frame_ms(model, device, kernels)
        runs[kernels] += times
        print(f"  {'kernel' if kernels else 'plain'} path, frames 1..{T - 1}:"
              f" {' '.join(f'{t:.2f}' for t in times)} ms", flush=True)
    per_frame = {k: statistics.median(v) for k, v in runs.items()}
    print(f"  rollout ms/frame (median of {len(runs[True])} frames): "
          f"kernel path {per_frame[True]:.3f}, plain path "
          f"{per_frame[False]:.3f}", flush=True)
    ref, srcs, coords = sweep_inputs(device, translation_poses(device))
    pref, psrcs = planar(ref), planar(srcs)
    args = resample_inputs(device, CFG.ndepth, 64, 96)
    pad = math.log(1.0 / CFG.ndepth)
    cl_ms = call_ms(
        lambda: ksweep.sweep_kernel(ref, srcs, coords, 10.0, "L2", 3))
    print(f"  sweep_fused on channels-last features: {cl_ms:.4f} ms "
          f"(the row below: planar, as KVNet passes them)", flush=True)
    calls = {
        "sweep_fused": (
            lambda: ksweep.sweep_kernel(pref, psrcs, coords, 10.0, "L2", 3),
            lambda: ksweep.sweep_plain(ref, srcs, coords, 10.0, "L2", 3),
            sweep_bound(ref, srcs, coords, 3)),
        "resample": (
            lambda: kresample.predict_next_cuda(*args, pad),
            lambda: kresample.predict_next_plain(*args, pad),
            resample_bound(1, CFG.ndepth, 64, 96)),
    }
    rows = {name: time_kernel(name, *c) for name, c in calls.items()}
    rows["resample"].update(time_predict_next(device))
    return {"per_frame": per_frame, "kernels": rows}


def time_kernel(name, kern, plain, bound_of, library=None) -> dict:
    """Kernel, plain twin and library call: call times in the order plain,
    kernel, kernel, plain (library, library around them), the kernel's
    device time (a graph of 100 launches) and host time per call between
    them, beside the bound. The row's ``ms`` is the device time."""
    p1, k1 = call_ms(plain), call_ms(kern)
    dev, host = device_ms(kern), host_us(kern)
    k2, p2 = call_ms(kern), call_ms(plain)
    lib = statistics.mean([call_ms(library) for _ in range(2)]) \
        if library else None
    row = {"ms": dev, "device_ms": dev, "call_ms": statistics.mean((k1, k2)),
           "host_us": host, "plain_ms": statistics.mean((p1, p2)),
           "bound_ms": bound_of[0], "bound_by": bound_of[1], "library_ms": lib}
    print(f"  {name}: device {dev:.4f} ms, call {k1:.4f} / {k2:.4f} ms, "
          f"host {host:.1f} us per call; plain {p1:.4f} / {p2:.4f} ms, "
          f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
          f"{bound_of[0]:.4f} ms ({bound_of[1]})", flush=True)
    return row


def time_predict_next(device) -> dict:
    """``predict_next`` as the step calls it, at N=1 and N=2, on both paths
    (host clock, each call ending in a sync); F.grid_sample's 5-D call on a
    pre-faced volume with a precomputed normalized grid, the nearest single
    PyTorch call (it samples only, so it is no ``library_ms``); and the
    device time of a one-element fill, the floor of one graph node."""
    row = {}
    for N in (1, 2):
        lv, poses, Ks, d = resample_inputs(device, CFG.ndepth, 64, 96,
                                           POSES[:N])
        kern = host_ms(lambda: predict_next(lv, poses, Ks, d))
        plain = host_ms(lambda: predict_next(lv, poses, Ks, d, False))
        row[f"predict_next_n{N}_ms"] = kern
        row[f"predict_next_plain_n{N}_ms"] = plain
        print(f"  predict_next as the step calls it, N={N} at (64, 64, 96): "
              f"kernel path {kern:.4f} ms, plain path (torch.linalg.inv, "
              f"resample_dpv per lane) {plain:.4f} ms, host clock to the "
              f"sync", flush=True)
    lv, poses, Ks, d = resample_inputs(device, CFG.ndepth, 64, 96)
    D, H, W = lv.shape[1:]
    vol = _set_vol_border(lv[0], math.log(1.0 / D))[None, None]
    cx, cy, cz = kresample.resample_pixel_coords(
        Camera(K=Ks[0]), torch.linalg.inv(poses[0]), d, H, W)
    grid = torch.stack([_pixel_to_normalized(cx, W),
                        _pixel_to_normalized(cy, H),
                        _pixel_to_normalized(cz, D)], -1).reshape(
                            1, D, H, W, 3)

    def sample():
        return torch.nn.functional.grid_sample(
            vol, grid, mode="bilinear", padding_mode="border",
            align_corners=True)

    print(f"  F.grid_sample 5-D (border, align_corners) on a pre-faced "
          f"(64, 64, 96) volume and grid: device {device_ms(sample):.4f} ms, "
          f"call {call_ms(sample):.4f} ms", flush=True)
    one = torch.zeros(1, device=device)
    row["graph_node_floor_ms"] = device_ms(one.zero_)
    print(f"  a one-element fill in the same graph timer (the floor of one "
          f"launch there): device {row['graph_node_floor_ms']:.4f} ms",
          flush=True)
    return row


def profile_step(model, device) -> None:
    """One kernel-path frame under torch.profiler: the 15 costliest ops."""
    from torch.profiler import ProfilerActivity, profile

    frames = frames_on(device, 2)
    step = make_infer_step(CFG)
    out = step(model, {k: v[0] for k, v in frames.items()}, bv0_on(device),
               [False])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, {k: v[1] for k, v in frames.items()}, out.bv_predict,
             [True])
        torch.cuda.synchronize()
    print("  profile of one fused frame (kernel path):", flush=True)
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=15,
                       max_name_column_width=48), flush=True)
    api = sorted((e for e in events if e.key.startswith("cuda")),
                 key=lambda e: -e.cpu_time_total)
    print("  CUDA runtime calls of that frame (host ms, count): " + "; ".join(
        f"{e.key} {e.cpu_time_total / 1e3:.2f} x{e.count}" for e in api[:10]),
        flush=True)


def conv_inputs(device, shape, N, seed=SEED):
    """Inputs at the scale a K-Net layer sees: post-BN-ReLU activations
    (bf16) and fan-out He weights."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g).relu().to(torch.bfloat16)
    w = torch.randn(3, 3, 3, shape[-1], N, generator=g) * math.sqrt(
        2.0 / (27 * N))
    return x.to(device), w.to(device)


def stats_ok(got, want, terms) -> bool:
    return bool(((got - want).abs() <= CONV_TOL["stats"] * terms).all())


def phase_conv(device, errs) -> None:
    print(f"phase 8: conv kernel vs plain twin at the K-Net layer "
          f"{KNET_LAYER} -> {CFG.kv_feature_dim} and at the coarse-D "
          f"K-Net's {KNET_LAYER_D32}", flush=True)
    for shape in (KNET_LAYER, KNET_LAYER_D32):
        x, w = conv_inputs(device, shape, CFG.kv_feature_dim)
        y, ssum, ssq = kconv.conv3d_kernel(x, w, torch.bfloat16, True)
        y32 = kconv.conv3d_kernel(x, w, torch.float32)
        want32 = kconv.conv3d_plain(x, w, torch.float32)
        want, wsum, wssq = kconv.conv3d_plain(x, w, torch.bfloat16, True)
        torch.cuda.synchronize()
        e32, e16 = max_err(y32, want32), max_err(y.float(), want.float())
        es, eq = max_err(ssum, wsum), max_err(ssq, wssq)
        errs += [e32, e16]
        check(within(y32, want32, *CONV_TOL["fp32"]),
              f"{shape} fp32 output: max|err| {e32:.3e} (|y| <= "
              f"{float(want32.abs().max()):.2f})")
        check(within(y.float(), want.float(), *CONV_TOL["bf16"]),
              f"{shape} bf16 output: max|err| {e16:.3e}, "
              f"{int((y != want).sum())} of {y.numel()} values one rounding "
              f"apart")
        check(stats_ok(ssum, wsum, want32.abs().sum((0, 1, 2)))
              and stats_ok(ssq, wssq, wssq),
              f"{shape} BatchNorm sums: max|err| {es:.3e} (|sum| <= "
              f"{float(wsum.abs().max()):.1f}), sums of squares {eq:.3e} "
              f"(<= {float(wssq.max()):.1f})")

    shape = (16, 24, 100, 16)
    x, w = conv_inputs(device, shape, 16, seed=SEED + 1)
    y, ssum, ssq = conv3d_dma(x, w, with_stats=True)
    want32 = kconv.conv3d_plain(x, w, torch.float32)
    want, wsum, wssq = kconv.conv3d_plain(x, w, torch.bfloat16, True)
    torch.cuda.synchronize()
    e16 = max_err(y.float(), want.float())
    errs.append(e16)
    check(within(y.float(), want.float(), *CONV_TOL["bf16"])
          and stats_ok(ssum, wsum, want32.abs().sum((0, 1, 2)))
          and stats_ok(ssq, wssq, wssq),
          f"conv3d_dma {shape} -> 16: max|err| {e16:.3e}, sums "
          f"{max_err(ssum, wsum):.3e}, sums of squares "
          f"{max_err(ssq, wssq):.3e}")

    shape = (4, 6, 70, 16)
    x, w = conv_inputs(device, shape, 24, seed=SEED + 2)
    x = x.float()
    cot = torch.randn(*shape[:3], 24,
                      generator=torch.Generator().manual_seed(SEED)).to(device)
    grads = []
    for fn in (kconv.conv3d_3x3x3, kconv.conv3d_fp32):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xg, wg) * cot).sum().backward()
        grads.append((xg.grad, wg.grad))
    torch.cuda.synchronize()
    (gx, gw), (px, pw) = grads
    check(within(gx, px, *CONV_TOL["grad"]) and within(gw, pw, *CONV_TOL["grad"]),
          f"conv3d_3x3x3 {shape} -> 24 gradients vs autograd through the "
          f"plain conv: max|err| x {max_err(gx, px):.3e}, w "
          f"{max_err(gw, pw):.3e}")


def phase_sweep_l2(device) -> None:
    print("phase 9: sweep_cost_volume_l2 on the card", flush=True)
    args = sweep_args(device, translation_poses(device))
    before = ksweep.launches
    cost, kept = sweep_cost_volume_l2(*args, 10.0, 3)
    launched = ksweep.launches - before
    want_cost, want_kept = ksweep.sweep_cost_volume_fused(*args, 10.0, "L2", 3)
    torch.cuda.synchronize()
    check(launched == 1 and torch.equal(cost, want_cost)
          and torch.equal(kept, want_kept),
          f"equals sweep_cost_volume_fused bit for bit; sweep kernel "
          f"launched {launched} time(s)")


def phase_fast(model, frames, depth) -> dict:
    print(f"phase 10: fast_knet rollout, T={T} at {IMG_HW[1]}x{IMG_HW[0]}",
          flush=True)
    launches, fdepth, _ = check_rollout(
        model, frames, expected_launches(T, T, 10 * (T - 1)),
        fast_knet=True)
    pdepth, _, _ = make_rollout(CFG, kernels=False, fast_knet=True)(
        model, frames, bv0_on(frames["ref"].device), [False])
    torch.cuda.synchronize()
    for name, other in (("fast kernel path vs fast plain path", pdepth),
                        ("fast kernel path vs exact kernel path", depth)):
        err = (fdepth - other).abs()
        check(float(err.mean()) < FAST_DEPTH_MEAN,
              f"{name}, depth: mean|err| {float(err.mean()):.3e} m, max "
              f"{float(err.max()):.3e} m over {T} frames")
    return launches


def phase_fast_timing(model, device) -> dict:
    print("phase 11: fast-path timing", flush=True)
    runs = {True: [], False: []}
    for fast in (False, True, True, False):
        times = frame_ms(model, device, True, fast_knet=fast)
        runs[fast] += times
        print(f"  {'fast_knet' if fast else 'exact'} kernel path, frames "
              f"1..{T - 1}: {' '.join(f'{t:.2f}' for t in times)} ms",
              flush=True)
    per_frame = {k: statistics.median(v) for k, v in runs.items()}
    print(f"  rollout ms/frame (median of {len(runs[True])} frames): "
          f"fast_knet {per_frame[True]:.3f}, exact {per_frame[False]:.3f}",
          flush=True)

    N = CFG.kv_feature_dim
    x, w = conv_inputs(device, KNET_LAYER, N)
    pw = kconv.pack_weights(w)
    layer = _layer(model.kv_net, "dres1_0")[0]    # a 64->64 K-Net conv
    xl = x.permute(3, 0, 1, 2)[None].contiguous(
        memory_format=torch.channels_last_3d)
    wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)

    def cudnn():
        return torch.nn.functional.conv3d(xl, wl, padding=1)

    bound_bf16 = conv_bound(KNET_LAYER, N, 2, True)
    flops = 2.0 * math.prod(KNET_LAYER) * 27 * N
    row = time_kernel(
        "conv3d per K-Net layer, pre-packed weights",
        lambda: kconv.conv3d_kernel(x, pw, torch.bfloat16, True),
        lambda: kconv.conv3d_plain(x, w, torch.bfloat16, True),
        bound_bf16, cudnn)
    print(f"  conv3d: {flops / row['ms'] * 1e-9:.1f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound "
          f"({flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16); cuDNN bf16 "
          f"{flops / row['library_ms'] * 1e-9:.1f} TFLOP/s", flush=True)
    time_kernel(
        "conv3d per K-Net layer as the rollout calls it (cached packing)",
        lambda: kconv.conv3d(x, packed_weights(layer), torch.bfloat16, True),
        lambda: kconv.conv3d_plain(x, w, torch.bfloat16, True),
        bound_bf16, cudnn)
    time_kernel(
        "conv3d per K-Net layer through the wrapper, packing every call",
        lambda: kconv.conv3d_kernel(x, w, torch.bfloat16, True),
        lambda: kconv.conv3d_plain(x, w, torch.bfloat16, True),
        bound_bf16, cudnn)
    time_kernel(
        "conv3d per K-Net layer, fp32 output (the conv3d_3x3x3 forward)",
        lambda: kconv.conv3d_kernel(x, pw, torch.float32),
        lambda: kconv.conv3d_plain(x, w, torch.float32),
        conv_bound(KNET_LAYER, N, 4, False), cudnn)

    def chain(conv, wt):
        z = x
        for _ in range(10):
            z = conv(z, wt, torch.bfloat16, True)[0]
        return z

    vol = torch.randn(*KNET_LAYER[:3], CFG.kvnet_in_channels,
                      generator=torch.Generator().manual_seed(SEED)).to(device)
    with torch.no_grad():
        k10 = call_ms(lambda: chain(kconv.conv3d_kernel, pw), reps=5)
        p10 = call_ms(lambda: chain(kconv.conv3d_plain, w), reps=5)
        fast = call_ms(lambda: knet_fast_apply(model.kv_net, vol), reps=5)
        exact = call_ms(lambda: model.kv_net(vol.permute(3, 0, 1, 2)[None]),
                        reps=5)
    print(f"  ten-layer conv chain: kernel {k10:.3f} ms, plain {p10:.3f} ms, "
          f"bound {10 * row['bound_ms']:.3f} ms; whole K-Net: "
          f"knet_fast_apply {fast:.3f} ms, fp32 KNet module {exact:.3f} ms",
          flush=True)
    pad = math.log(1.0 / CFG.ndepth)
    for h, w in ((64, 192), (256, 384)):
        args = resample_inputs(device, CFG.ndepth, h, w)
        time_kernel(f"resample at (64, {h}, {w})",
                    lambda: kresample.predict_next_cuda(*args, pad),
                    lambda: kresample.predict_next_plain(*args, pad),
                    resample_bound(1, CFG.ndepth, h, w))
    return {"per_frame": per_frame, "conv3d": row}


def sync_sites(fn, tag=None) -> dict:
    """{(place in the port or this script, message): count} of the host
    syncs ``fn`` makes on the main thread, under
    ``torch.cuda.set_sync_debug_mode("warn")``; the place is the innermost
    frame of the Python stack in either. With ``tag``, a callable, each
    key starts with what it returns when the sync is seen."""
    sites: dict = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if ("synchronizing CUDA operation" not in str(message)
                or threading.current_thread() is not threading.main_thread()):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "neuralrgbd_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        where = (f"{frames[-1].filename.split('/')[-1]}:{frames[-1].lineno} "
                 f"{frames[-1].line}") if frames else f"{filename}:{lineno}"
        key = (where, str(message))
        if tag is not None:
            key = (tag(), *key)
        sites[key] = sites.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def phase_syncs(model, device) -> None:
    print("phase 12: host syncs in one kernel-path step "
          "(torch.cuda.set_sync_debug_mode)", flush=True)
    frames = frames_on(device, 2, n_lanes=2)
    batch = [{k: v[t] for k, v in frames.items()} for t in range(2)]
    step = make_infer_step(CFG)
    out = step(model, batch[0], bv0_on(device).expand(2, -1, -1, -1),
               [False, False])
    d = torch.as_tensor(CFG.d_candi, device=device)
    probe = sync_sites(lambda: torch.zeros(1, device=device).item())
    check(len(probe) == 1, f"the sync probe sees .item(): {list(probe)}")
    sites = sync_sites(lambda: predict_next(out.dpv, batch[1]["pose_next"],
                                            batch[1]["K"], d))
    check(not sites, f"predict_next (kernel path, N=2) makes no host sync "
          f"({sum(sites.values())} seen: {list(sites)})")
    sites = sync_sites(lambda: step(model, batch[1], out.bv_predict,
                                    [True, True]))
    print(f"  one kernel-path step of 2 lanes syncs "
          f"{sum(sites.values())} time(s):", flush=True)
    for (where, message), n in sorted(sites.items()):
        print(f"    {n} x {where}: {message}", flush=True)


def _set_tf32(flags) -> None:
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = flags


def _tf32() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def tf32_rollouts(model, frames, device) -> list:
    """T=4 rollouts under the caller's flags off, at PyTorch's defaults, all
    on and off again: [(name, (depth, confidence, prediction))]."""
    runs = []
    for name, flags in (("off", (False, False)),
                        ("PyTorch's defaults", TORCH_TF32_DEFAULTS),
                        ("all on", (True, True)), ("off again", (False, False))):
        _set_tf32(flags)
        out = make_rollout(CFG)(model, frames, bv0_on(device), [False])
        torch.cuda.synchronize()
        check(_tf32() == flags, f"flags {name} {flags}: after the rollout "
              f"they read {_tf32()}")
        runs.append((name, out))
    return runs


@contextlib.contextmanager
def tf32_numerics_only(tf32: bool):
    """``infer.step.step_numerics`` without its deterministic cuDNN
    algorithms: phase 13 times the step with cuDNN's default choice
    through it, and nothing else uses it."""
    saved = _tf32()
    _set_tf32((tf32, tf32))
    try:
        yield
    finally:
        _set_tf32(saved)


def phase_tf32(model, device) -> None:
    cudnn = torch.backends.cudnn
    print(f"phase 13: the step's numerics, T=4 rollouts at "
          f"{IMG_HW[1]}x{IMG_HW[0]} under the caller's global flags "
          f"(TF32 cudnn, matmul); PyTorch's defaults here: "
          f"{TORCH_TF32_DEFAULTS}, cudnn.deterministic "
          f"{TORCH_DETERMINISTIC_DEFAULT}", flush=True)
    frames = frames_on(device, 4)
    saved = _tf32()
    check(cudnn.deterministic == TORCH_DETERMINISTIC_DEFAULT,
          f"this script leaves torch.backends.cudnn.deterministic at "
          f"PyTorch's default ({cudnn.deterministic})")
    runs = tf32_rollouts(model, frames, device)
    _set_tf32(TORCH_TF32_DEFAULTS)
    again = make_rollout(CFG)(model, frames, bv0_on(device), [False])
    torch.cuda.synchronize()
    runs.append(("PyTorch's defaults, a second run", again))
    for name, out in runs[1:]:
        e = max_err(out[0], runs[0][1][0])
        check(all(torch.equal(a, b) for a, b in zip(out, runs[0][1])),
              f"global flags {name}: depth, confidence and prediction equal "
              f"the flags-off rollout bit for bit (max|depth err| "
              f"{e:.3e} m)")
    check(cudnn.deterministic == TORCH_DETERMINISTIC_DEFAULT,
          f"after the rollouts cudnn.deterministic reads as the caller left "
          f"it ({cudnn.deterministic})")
    _set_tf32((False, False))
    depth, conf, _ = make_rollout(CFG, tf32=True)(model, frames,
                                                  bv0_on(device), [False])
    torch.cuda.synchronize()
    check(_tf32() == (False, False), f"tf32=True rollout leaves the flags as "
          f"the caller set them: {_tf32()}")
    err = (depth - runs[0][1][0]).abs()
    print(f"  the deviation TF32 makes (tf32=True vs fp32, 4 frames): depth "
          f"max {float(err.max()):.3e} m, mean {float(err.mean()):.3e} m; "
          f"confidence max {max_err(conf, runs[0][1][1]):.3e}", flush=True)
    times = {"deterministic": [], "default": []}
    for kind in ("deterministic", "default", "default", "deterministic"):
        numerics = step_mod.step_numerics
        if kind == "default":
            step_mod.step_numerics = tf32_numerics_only
        try:
            times[kind] += frame_ms(model, device, True)
        finally:
            step_mod.step_numerics = numerics
    print(f"  {CARD[0]}: ms per frame (median of "
          f"{len(times['default'])} frames, events around each step, in "
          f"turns): the step (deterministic cuDNN algorithms) "
          f"{statistics.median(times['deterministic']):.3f}, cuDNN's "
          f"default choice {statistics.median(times['default']):.3f}",
          flush=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            make_infer_step(CFG)(model, {k: v[1] for k, v in frames.items()},
                                 bv0_on(device), [True])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    print(f"  ops of a step without a deterministic implementation "
          f"(torch.use_deterministic_algorithms, warn_only): {ops or 'none'}",
          flush=True)
    _set_tf32(saved)


class StepProbe:
    """Wraps ``make_infer_step`` where ``module`` calls it: the host time
    of each step call, when it started, and a CUDA event recorded after
    it. Consecutive events are a frame period as the card sees it: the
    step's work plus whatever the host issued, or failed to issue, between
    two steps. On a host-bound frame the period is the step's host time
    plus the caller's host time between two steps (``between_ms``)."""

    def __init__(self, module):
        self.module, self.make = module, module.make_infer_step
        self.host_ms: list[float] = []
        self.starts: list[float] = []
        self.events: list = []

    def __enter__(self):
        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def timed(*a, **k):
                t = time.perf_counter()
                self.starts.append(t)
                out = step(*a, **k)
                self.host_ms.append(1e3 * (time.perf_counter() - t))
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
                return out
            return timed

        self.module.make_infer_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_infer_step = self.make

    def frame_ms(self) -> list[float]:
        """Frame periods of frames 1.. (frame 0 has no predecessor)."""
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                  self.events[1:])]

    def between_ms(self) -> list[float]:
        """The caller's host ms between the end of step k and the start of
        step k+1, for frames 1.."""
        return [1e3 * (b - a) - h for a, b, h in zip(
            self.starts, self.starts[1:], self.host_ms)]


def loop_args(root: str, ckpt: str, res_dir: str) -> list[str]:
    """The CLI flags of phases 14 and 15: the operating point, spelled out."""
    return ["--dataset", "scannet", "--dataset_path", root,
            "--model_path", ckpt, "--res_dir", res_dir, "--exp_name", "loop",
            "--ndepth", str(CFG.ndepth), "--feature_dim", str(CFG.feature_dim),
            "--d_min", str(CFG.d_min), "--d_max", str(CFG.d_max),
            "--t_win", str(CFG.t_win_r), "--img_width", str(IMG_HW[1]),
            "--img_height", str(IMG_HW[0]), "--device", "cuda"]


def quiet(fn, *args, **kwargs):
    """Run ``fn`` with its standard output captured; return (result, out)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args, **kwargs)
    return result, buf.getvalue()


def check_contract(out_dir: str, depth_in_range: bool = True) -> None:
    """The export contract of ``out_dir``; ``depth_in_range=False`` (DGF's
    guided filter) bounds the depth by 0 only."""
    files = set(os.listdir(out_dir))
    want = {f"{p}_{i:05d}.{ext}" for i in range(T_LOOP)
            for p, ext in (("img", "png"), ("d", "pgm"), ("conf", "pgm"))}
    check(files == want | {"scene_path_info.txt"},
          f"the export contract: {len(want)} files for {T_LOOP} frames and "
          f"scene_path_info.txt ({len(files)} files; missing "
          f"{sorted(want - files)[:4]}, extra "
          f"{sorted(files - want - {'scene_path_info.txt'})[:4]})")
    rows = open(os.path.join(out_dir, "scene_path_info.txt")).read() \
        .splitlines()
    t = CFG.t_win_r
    check(len(rows) == T_LOOP + 1 and rows[0] == "scene0000_00" and all(
        r.split("  ")[0] == str(i) and r.endswith(
            f"frame-{5 * (i + t):06d}.color.jpg")
        for i, r in enumerate(rows[1:])),
        f"scene_path_info.txt: a header and {T_LOOP} rows in frame order "
        f"({len(rows)} lines)")
    d = np.stack([read_pgm(os.path.join(out_dir, f"d_{i:05d}.pgm"))
                  for i in range(T_LOOP) if f"d_{i:05d}.pgm" in files])
    c = np.stack([read_pgm(os.path.join(out_dir, f"conf_{i:05d}.pgm"))
                  for i in range(T_LOOP) if f"conf_{i:05d}.pgm" in files])
    lo, hi = (1000 * CFG.d_min, 1000 * CFG.d_max) if depth_in_range \
        else (0, 65535)
    check(d.shape[1:] == IMG_HW and d.min() >= lo - 1 and d.max() <= hi,
          f"depth pgm in [{lo:.0f}, {hi:.0f}]: [{d.min()}, {d.max()}], "
          f"shape {d.shape}")
    check(c.max() <= 1000 and c.min() > 0,
          f"confidence pgm in (0, 1000]: [{c.min()}, {c.max()}]")


def rollout_windows(traj, device) -> dict:
    """The T_LOOP windows of the loop, by ``window_batch``, on the card."""
    keys = ("ref", "srcs", "poses", "K", "pose_next")
    batches = [window_batch(traj, ref, CFG.t_win_r)[0]
               for ref in range(CFG.t_win_r, CFG.t_win_r + T_LOOP)]
    return {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(device)
            for k in keys}


def pgm_diff(a: str, b: str, n: int | None = None) -> int:
    """Max |difference| in units over the first n frames' d_ and conf_."""
    n = T_LOOP if n is None else min(n, T_LOOP)
    return max(int(np.abs(
        read_pgm(os.path.join(a, f"{p}_{t:05d}.pgm")).astype(np.int64)
        - read_pgm(os.path.join(b, f"{p}_{t:05d}.pgm")).astype(np.int64)).max())
        for t in range(n) for p in ("d", "conf"))


class ThreadTimes(contextlib.AbstractContextManager):
    """Host ms of each call of ``module.name`` (from any thread)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn, self.ms = getattr(module, name), []

    def __enter__(self):
        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return self.fn(*args, **kwargs)
            finally:
                self.ms.append(1e3 * (time.perf_counter() - t))
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def scene_and_checkpoint(model, tmp: str) -> tuple[str, str]:
    """Phase 14's 40-frame scene on disk and ``model``'s weights saved as a
    reference-style ``.tar``: (dataset root, checkpoint path)."""
    root = os.path.join(tmp, "scenes")
    t0 = time.perf_counter()
    write_plane_scene(root, 0, n_frames=SCENE_FRAMES)
    ckpt = os.path.join(tmp, "kvnet.tar")
    torch.save({"state_dict": {f"module.{k}": v.cpu()
                               for k, v in model.state_dict().items()}}, ckpt)
    print(f"  wrote the scene and the checkpoint in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return root, ckpt


def phase_loop(model, device, tmp: str) -> dict:
    print(f"phase 14: the production loop through cli.test_kvnet, "
          f"{SCENE_FRAMES}-frame write_plane_scene at 640x480 read at "
          f"{IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    root, ckpt = scene_and_checkpoint(model, tmp)

    for mod in KERNELS.values():
        mod.launches = 0
    with StepProbe(loop_mod) as probe:
        t0 = time.perf_counter()
        _, out = quiet(cli_test_kvnet.main,
                       loop_args(root, ckpt, os.path.join(tmp, "cli")))
        cli_s = time.perf_counter() - t0
    runs = {"loop": [probe], "rollout": []}
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    print("  " + "\n  ".join(ln for ln in out.splitlines()
                              if not ln.startswith("Finished frame")),
          flush=True)
    check(launches == expected_launches(T_LOOP, T_LOOP, knet=T_LOOP - 1),
          f"launches in the CLI's run: {launches} (expected {T_LOOP} sweeps, "
          f"{T_LOOP} resamples, no bf16 K-Net conv, {FE_LAUNCHES} conv2d_bn "
          f"a frame and {KNET_F32_LAUNCHES} conv3d_f32 a frame but the "
          f"first)")
    out_dir = os.path.join(tmp, "cli", "loop_0")
    check_contract(out_dir)

    traj = make_trajectory(0, 5, root, img_size_wh=IMG_HW[::-1],
                           d_candi=CFG.d_candi)
    windows = rollout_windows(traj, device)
    loop_s = []
    with ThreadTimes(loop_mod.pp, "load_raw") as decode, \
            ThreadTimes(loop_mod, "export_frame") as export:
        for turn in ("rollout", "loop", "rollout", "loop", "rollout"):
            with StepProbe(loop_mod if turn == "loop" else rollout_mod) \
                    as probe:
                if turn == "rollout":
                    make_rollout(CFG)(model, windows, bv0_on(device), [False])
                else:
                    t0 = time.perf_counter()
                    loop_mod.run_trajectory(
                        model, CFG, traj,
                        os.path.join(tmp, f"loop{len(loop_s)}"), verbose=False)
                    loop_s.append(time.perf_counter() - t0)
            runs[turn].append(probe)
    diff = pgm_diff(out_dir, os.path.join(tmp, "loop0"))
    check(diff == 0, f"run to run on the card: the CLI's maps equal the "
          f"next loop run's (deterministic step): max |diff| {diff} unit(s) "
          f"over {T_LOOP} frames")

    # the loop against the rollout on the same windows
    depth, conf, _ = make_rollout(CFG)(model, windows, bv0_on(device),
                                       [False])
    errs = []
    for name, maps in (("d", depth), ("conf", conf)):
        for t in range(T_LOOP):
            want = loop_mod._q16(maps[t, 0]).cpu().numpy().view(np.uint16)
            got = read_pgm(os.path.join(out_dir, f"{name}_{t:05d}.pgm"))
            errs.append((t, int(np.abs(got.astype(np.int64)
                                       - want.astype(np.int64)).max())))
    check(max(e for _, e in errs) == 0, f"all {T_LOOP} frames' maps equal "
          f"the rollout's on the same windows (the loop normalizes as "
          f"window_batch does): max |diff| {max(e for _, e in errs)} "
          f"unit(s)")

    # medians over frames 2.. of every run of a kind: the frame period the
    # card sees, the step's host time, the caller's host time between steps
    stat = {kind: {
        "period": [t for p in probes for t in p.frame_ms()[1:]],
        "step": [t for p in probes for t in p.host_ms[2:]],
        "between": [t for p in probes for t in p.between_ms()[1:]],
    } for kind, probes in runs.items()}
    med = {kind: {k: statistics.median(v) for k, v in d.items()}
           for kind, d in stat.items()}
    loop_ms, roll_ms = med["loop"]["period"], med["rollout"]["period"]
    print(f"  {CARD[0]}: ms per frame, frames 2..{T_LOOP - 1} (CUDA events "
          f"after each step), loop {loop_ms:.3f} vs rollout {roll_ms:.3f} "
          f"({100 * (loop_ms / roll_ms - 1):+.1f}%); per run, loop "
          f"{[round(statistics.median(p.frame_ms()[1:]), 3) for p in runs['loop']]}"
          f", rollout "
          f"{[round(statistics.median(p.frame_ms()[1:]), 3) for p in runs['rollout']]}",
          flush=True)
    for kind in ("loop", "rollout"):
        print(f"  {kind}, host ms per frame (medians): the step's call "
              f"{med[kind]['step']:.3f}, the main thread between steps "
              f"{med[kind]['between']:.3f}", flush=True)
    print(f"  the CLI's whole run {cli_s:.2f} s (model build, checkpoint, "
          f"{T_LOOP} frames, export); run_trajectory alone "
          f"{[round(x, 2) for x in loop_s]} s, "
          f"{1e3 * statistics.median(loop_s) / T_LOOP:.2f} ms per frame to "
          f"the last file; worker threads, wall ms per call (median): "
          f"decode (load_raw) {statistics.median(decode.ms):.2f}, export "
          f"(export_frame) {statistics.median(export.ms):.2f}", flush=True)
    if loop_ms > 1.1 * roll_ms:
        d_step = med["loop"]["step"] - med["rollout"]["step"]
        d_between = med["loop"]["between"] - med["rollout"]["between"]
        stage = ("the step's own host time, its launches slowed by the "
                 "loop's decode and export threads" if d_step >= d_between
                 else "the loop's own work on the main thread between "
                      "steps (uploads, window assembly, quantization)")
        print(f"  the loop is {100 * (loop_ms / roll_ms - 1):.1f}% slower "
              f"than the rollout; the host stage that accounts for it: "
              f"{stage} (step {d_step:+.3f} ms, between steps "
              f"{d_between:+.3f} ms per frame)", flush=True)

    sites = sync_sites(lambda: loop_mod.run_trajectory(
        model, CFG, traj, os.path.join(tmp, "sync"), verbose=False))
    n_sync = sum(sites.values())
    print(f"  the main thread's host syncs in one run_trajectory of "
          f"{T_LOOP} frames: {n_sync} ({n_sync / T_LOOP:.2f} per frame)",
          flush=True)
    for (where, message), n in sorted(sites.items()):
        print(f"    {n} x {where}: {message}", flush=True)
    return {"root": root, "ckpt": ckpt, "windows": windows}


def phase_evaluate(loop_info: dict, tmp: str) -> None:
    print("phase 15: cli.evaluate on the same scene and checkpoint",
          flush=True)
    result, out = quiet(cli_evaluate.main, loop_args(
        loop_info["root"], loop_info["ckpt"], os.path.join(tmp, "eval")))
    print(f"  {out.strip().splitlines()[-1]}", flush=True)
    check(bool(result) and result.get("n_valid", 0) > 0 and all(
        math.isfinite(v) for v in result.values()),
          f"finite metrics over n_valid = {result.get('n_valid')} pixels")


def maps_equal_rollout(out_dir: str, depth, conf) -> int:
    """Max |difference| in pgm units between the export in ``out_dir`` and
    ``_q16`` of a rollout's depth and confidence on the same windows."""
    worst = 0
    for name, maps in (("d", depth), ("conf", conf)):
        for t in range(T_LOOP):
            want = loop_mod._q16(maps[t, 0]).cpu().numpy().view(np.uint16)
            got = read_pgm(os.path.join(out_dir, f"{name}_{t:05d}.pgm"))
            worst = max(worst, int(np.abs(got.astype(np.int64)
                                          - want.astype(np.int64)).max()))
    return worst


def cli_flag_run(model, loop_info: dict, tmp: str, name: str, flags: list,
                 cfg=CFG, ckpt: str | None = None, **rollout_kw) -> dict:
    """``cli.test_kvnet`` with ``flags`` on phase 14's scene (its checkpoint,
    or ``ckpt``): its launches, the export contract, and its maps against
    ``make_rollout(cfg, **rollout_kw)`` on the same windows. Returns the
    launches. With ``cache_features`` each of the scene's frames is
    featurized once: the windows' frames, 2 t_win_r more than windows."""
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    _, out = quiet(cli_test_kvnet.main, loop_args(
        loop_info["root"], ckpt or loop_info["ckpt"],
        os.path.join(tmp, name)) + flags)
    cli_s = time.perf_counter() - t0
    launches = {n: mod.launches for n, mod in KERNELS.items()}
    print("  " + "\n  ".join(ln for ln in out.splitlines()
                              if not ln.startswith("Finished frame")),
          flush=True)
    fe_calls = (T_LOOP + 2 * CFG.t_win_r
                if rollout_kw.get("cache_features") else T_LOOP)
    want = expected_launches(
        T_LOOP, T_LOOP, extractor=fe_calls,
        knet=knet_steps(T_LOOP - 1, cfg, rollout_kw.get("fast_knet", False)))
    check(launches == want,
          f"cli.test_kvnet {' '.join(flags)}: launches {launches} "
          f"(expected {want}), whole run {cli_s:.2f} s")
    out_dir = os.path.join(tmp, name, "loop_0")
    check_contract(out_dir, depth_in_range=cfg.refine_net != "DGF")
    windows = loop_info["windows"]
    depth, conf, _ = make_rollout(cfg, **rollout_kw)(
        model, windows, bv0_on(windows["ref"].device), [False])
    diff = maps_equal_rollout(out_dir, depth, conf)
    check(diff == 0, f"cli.test_kvnet {' '.join(flags)}: all {T_LOOP} "
          f"frames' maps equal make_rollout({rollout_kw}) on the same "
          f"windows: max |diff| {diff} unit(s)")
    return launches


def phase_cached(model, device, loop_info: dict, tmp: str) -> None:
    print(f"phase 16: cached features, T={T} sliding windows of phase 14's "
          f"scene at {IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    frames = {k: v[:T] for k, v in loop_info["windows"].items()}
    fe = model.feature_extractor["feature_extraction"]
    calls, at_step = [], []
    hook = fe.register_forward_hook(lambda *args: calls.append(1))
    make = rollout_mod.make_infer_step

    def counting(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(*a, **k):
            at_step.append(len(calls))
            return step(*a, **k)
        return counted

    rollout_mod.make_infer_step = counting
    try:
        _, cdepth, cconf = check_rollout(
            model, frames,
            expected_launches(T, T, extractor=T + 2 * CFG.t_win_r,
                              knet=T - 1),
            cache_features=True)
    finally:
        rollout_mod.make_infer_step = make
        hook.remove()
    r = CFG.t_win_r
    per_step = [b - a for a, b in zip(at_step, at_step[1:])]
    check(at_step[:1] == [2 * r + 1] and per_step == [1] * (T - 1),
          f"extractor calls by the start of each step: {at_step} (window "
          f"0's {2 * r} frames and one new frame a step, {2 * r + 1} then "
          f"1 per step)")
    pdepth, pconf, _ = make_rollout(CFG, kernels=False, cache_features=True)(
        model, frames, bv0_on(device), [False])
    torch.cuda.synchronize()
    for name, got, want in (("depth", cdepth, pdepth),
                            ("confidence", cconf, pconf)):
        e = max_err(got, want)
        check(e <= ROLLOUT_TOL[name], f"cached kernel path vs cached plain "
              f"path, {name}: max|err| {e:.3e} over {T} frames")
    fe1 = make_frame_features()
    step = make_infer_step(CFG, with_features=True)
    bv, valid, same = bv0_on(device), [False], True
    for t in range(T):
        sb = {k: v[t] for k, v in frames.items()}
        window = [fe1(model, f) for f in (*sb["srcs"][0], sb["ref"][0])]
        feats = tuple(torch.stack([f[j] for f in window])[None]
                      for j in (0, 1))
        out = step(model, sb, bv, valid, feats)
        same = (same and torch.equal(out.depth, cdepth[t])
                and torch.equal(out.confidence, cconf[t]))
        bv, valid = out.bv_predict, [True]
    check(same, "the cached rollout equals a stepwise oracle that "
          "featurizes every window frame fresh (make_frame_features, "
          "with_features), bit for bit")
    edepth, _, _ = make_rollout(CFG)(model, frames, bv0_on(device), [False])
    err = (cdepth - edepth).abs()
    print(f"  cached vs exact (joint-window BN) path, depth: mean "
          f"{float(err.mean()):.3e} m, max {float(err.max()):.3e} m over "
          f"{T} frames (random weights)", flush=True)
    cli_flag_run(model, loop_info, tmp, "cli_cached", ["--cache_features"],
                 cache_features=True)


def phase_coarse(model, device, frames, depth, loop_info: dict,
                 tmp: str) -> int:
    print(f"phase 17: the coarse-D K-Net (knet_coarse_d = 2), T={T} at "
          f"{IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    runs, conv_d = {}, []
    conv = kpair.conv3d

    def recording(x, *args, **kwargs):
        conv_d.append(x.shape[0])
        return conv(x, *args, **kwargs)

    kpair.conv3d = recording
    try:
        for name, fast in (("exact", False), ("fast_knet", True)):
            launches, cdepth, _ = check_rollout(
                model, frames,
                expected_launches(T, T, 10 * (T - 1) if fast else 0,
                                  knet=knet_steps(T - 1, fast_knet=fast)),
                coarse_knet=2, fast_knet=fast)
            runs[name] = launches, cdepth
    finally:
        kpair.conv3d = conv
    # 10 (T - 1) launches in the rollout, 10 in check_rollout's extra step
    check(set(conv_d) == {CFG.ndepth // 2} and len(conv_d) == 10 * T,
          f"the conv kernel ran at D = {sorted(set(conv_d))} "
          f"({len(conv_d)} launches; expected D = {CFG.ndepth // 2})")
    for name, fast in (("exact", False), ("fast_knet", True)):
        cdepth = runs[name][1]
        check(torch.equal(cdepth[0], depth[0]),
              f"coarse-D {name}, frame 0 (no K-Net) equals phase 5's exact "
              f"path bit for bit")
        pdepth, _, _ = make_rollout(CFG, kernels=False, coarse_knet=2,
                                    fast_knet=fast)(
            model, frames, bv0_on(device), [False])
        torch.cuda.synchronize()
        err = (cdepth - pdepth).abs()
        ok = (float(err.mean()) < BF16_ROLLOUT_MEAN if fast
              else float(err.max()) <= ROLLOUT_TOL["depth"])
        check(ok, f"coarse-D {name}: kernel path vs plain path, depth max "
              f"{float(err.max()):.3e} m, mean {float(err.mean()):.3e} m "
              f"(bound: {'mean' if fast else 'max'} 1e-2)")
        dev = (cdepth - depth).abs()
        print(f"  coarse-D {name} vs phase 5's exact path, depth: mean "
              f"{float(dev.mean()):.3e} m, max {float(dev.max()):.3e} m",
              flush=True)
    N = CFG.kv_feature_dim
    x, w = conv_inputs(device, KNET_LAYER_D32, N)
    pw = kconv.pack_weights(w)
    xl = x.permute(3, 0, 1, 2)[None].contiguous(
        memory_format=torch.channels_last_3d)
    wl = w.to(torch.bfloat16).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    time_kernel(
        f"conv3d per coarse-D K-Net layer {KNET_LAYER_D32}, pre-packed",
        lambda: kconv.conv3d_kernel(x, pw, torch.bfloat16, True),
        lambda: kconv.conv3d_plain(x, w, torch.bfloat16, True),
        conv_bound(KNET_LAYER_D32, N, 2, True),
        lambda: torch.nn.functional.conv3d(xl, wl, padding=1))
    cli_flag_run(model, loop_info, tmp, "cli_coarse",
                 ["--knet_coarse_d", "2"], coarse_knet=2)
    return runs["fast_knet"][0]["conv3d"]


def phase_bf16(model, device, frames, depth, loop_info: dict) -> None:
    print(f"phase 18: bf16 convs (dtype='bfloat16'), T={T} at "
          f"{IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    model16 = KVNet(BF16, device=device, seed=SEED, single_refine=True)
    model16.load_state_dict(model.state_dict())
    _, bdepth, _ = check_rollout(     # a bf16 extractor runs its modules
        model16, frames, expected_launches(T, T, extractor=0), cfg=BF16)
    pdepth, _, _ = make_rollout(BF16, kernels=False)(
        model16, frames, bv0_on(device), [False])
    torch.cuda.synchronize()
    err = (bdepth - pdepth).abs()
    check(float(err.mean()) < BF16_ROLLOUT_MEAN,
          f"bf16 kernel path vs plain path, depth: mean "
          f"{float(err.mean()):.3e} m (bound 1e-2), max "
          f"{float(err.max()):.3e} m")
    err = (bdepth - depth).abs()
    check(float(err.mean()) < FAST_DEPTH_MEAN,
          f"bf16 vs phase 5's fp32 exact path, depth: mean "
          f"{float(err.mean()):.3e} m (bound {FAST_DEPTH_MEAN}), max "
          f"{float(err.max()):.3e} m")
    time_paths(model, model16, loop_info)


def time_paths(model, model16, loop_info: dict) -> None:
    """ms per frame of each path on the first T windows of phase 14's
    scene, in turns (each path twice, the order reversed the second
    time): the frame period the card sees (events after each step, frames
    2..T-1, ``StepProbe``)."""
    frames = {k: v[:T] for k, v in loop_info["windows"].items()}
    cast = layers_mod._cast

    def cast_every_call(module, name, dtype):
        return getattr(module, name).to(dtype)

    paths = {
        "exact": (model, CFG, {}),
        "cached features": (model, CFG, {"cache_features": True}),
        "coarse-D": (model, CFG, {"coarse_knet": 2}),
        "fast_knet": (model, CFG, {"fast_knet": True}),
        "coarse-D + fast_knet": (model, CFG, {"coarse_knet": 2,
                                              "fast_knet": True}),
        "bf16": (model16, BF16, {}),
        "bf16, weights cast every call": (model16, BF16, {}),
        "bf16 + cached features + coarse-D fast_knet": (
            model16, BF16, {"cache_features": True, "coarse_knet": 2,
                            "fast_knet": True}),
    }
    times = {name: [] for name in paths}
    for name in [*paths, *reversed(paths)]:
        m, cfg, kw = paths[name]
        if name.endswith("every call"):
            layers_mod._cast = cast_every_call
        try:
            with StepProbe(rollout_mod) as probe:
                make_rollout(cfg, **kw)(m, frames,
                                        bv0_on(frames["ref"].device), [False])
            times[name] += probe.frame_ms()[1:]
        finally:
            layers_mod._cast = cast
    exact = statistics.median(times["exact"])
    print(f"  {CARD[0]}: ms per frame (median of {len(times['exact'])} "
          f"frames, 2 turns each, in turns):", flush=True)
    for name, t in times.items():
        med = statistics.median(t)
        print(f"    {name}: {med:.3f} ({100 * (med / exact - 1):+.1f}% on "
              f"exact); per frame {' '.join(f'{x:.1f}' for x in t)}",
              flush=True)
    time_features(model, model16, frames)


def extractor_input(frames) -> torch.Tensor:
    """The first window's 5 frames, (5, 3, H, W), as the step hands them
    to the feature extractor."""
    return torch.cat([frames["srcs"][0, 0], frames["ref"][0, :1]]).permute(
        0, 3, 1, 2).contiguous()


def time_features(model, model16, frames) -> None:
    """The feature extractor alone, ms per call (CUDA events around 5
    calls, ``call_ms``): the window's 5 frames in one batch (the exact
    path's call) and one frame (the cached path's call a step), fp32 on
    the conv kernel and on cuDNN, and bf16 (its modules), in the step's
    numerics; and the 5-frame fp32 batch on cuDNN with its default
    algorithm choice. Each twice, the order reversed the second time."""
    x5 = extractor_input(frames)
    numerics = step_mod.step_numerics
    cases = {
        "fp32, 5 frames, conv kernel": (model, x5, numerics, True),
        "fp32, 5 frames, cuDNN": (model, x5, numerics, False),
        "fp32, 1 frame, conv kernel": (model, x5[-1:], numerics, True),
        "fp32, 1 frame, cuDNN": (model, x5[-1:], numerics, False),
        "bf16, 5 frames": (model16, x5, numerics, True),
        "bf16, 1 frame": (model16, x5[-1:], numerics, True),
        "fp32, 5 frames, cuDNN's default choice": (model, x5,
                                                   tf32_numerics_only, False),
    }
    ms = {name: [] for name in cases}
    launches = {}
    for name in [*cases, *reversed(cases)]:
        m, x, numerics, kernels = cases[name]
        fe = m.feature_extractor["feature_extraction"]
        with torch.no_grad(), numerics(False):
            ms[name].append(call_ms(lambda: fe(x, kernels), reps=5))
            launches[name] = kernel_launches(lambda: fe(x, kernels))
    print(f"  {CARD[0]}: the feature extractor alone at "
          f"{IMG_HW[1]}x{IMG_HW[0]}, ms per call (kernel launches per "
          f"call): " + "; ".join(
              f"{name} {statistics.mean(v):.3f} ({v[0]:.3f} / {v[1]:.3f}; "
              f"{launches[name]})" for name, v in ms.items()), flush=True)


def kernel_launches(fn) -> int:
    """The kernel launches one call of ``fn`` issues: its CUDA runtime
    calls named ``cudaLaunchKernel*`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel"))


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: mod.launches for name, mod in KERNELS.items()}


def train_batch(cfg, device, n_lanes: int, seed: int, img_hw=None) -> dict:
    """A labelled ``synthetic_batch`` on ``device`` (at ``IMG_HW`` unless
    given), as the loop uploads it (``lane_valid`` stays on the host); the
    4D-bin labels only under ``refine_dup``, as the loaders give them."""
    batch, _ = synthetic_batch(cfg, n_lanes=n_lanes, img_hw=img_hw or IMG_HW,
                               seed=seed)
    if not cfg.refine_dup:
        del batch["dmap_up4_imgsize_digit"]
    return upload_batch(batch, device)


def train_state(cfg, device, weights=None):
    """A fresh ``TrainState`` (both R-Net passes) on seeded weights, or on
    ``weights`` (a state_dict) when given."""
    model = KVNet(cfg, device=device, seed=SEED)
    if weights is not None:
        model.load_state_dict(weights)
    return create_train_state(cfg, TRAIN, model=model)


def random_carry(n: int, D: int, h: int, w: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(SEED)
    return torch.log_softmax(torch.randn(n, D, h, w, generator=g), 1).to(
        device)


def phase_train(device, loop_info: dict, tmp: str) -> dict:
    print(f"phase 19: training at {IMG_HW[1]}x{IMG_HW[0]}, D={CFG.ndepth}, "
          f"V={CFG.n_views}, feature_dim {CFG.feature_dim}, fp32, TF32 off",
          flush=True)
    step = make_train_step(CFG, TRAIN)
    state = train_state(CFG, device)
    weights = {k: v.clone() for k, v in state.model.state_dict().items()}
    one = train_batch(CFG, device, 1, SEED)
    reset_launches()
    losses = [step(state, one, bv0_on(device), [False]).loss
              for _ in range(TRAIN_STEPS)]
    launches = read_launches()
    check(launches == expected_launches(0, TRAIN_STEPS),
          f"launches in {TRAIN_STEPS} train steps: {launches} (the carry on "
          f"the resample kernel once a step; the forward on the plain ops)")
    vals = torch.stack(losses).cpu()
    check(bool(torch.isfinite(vals).all()) and float(vals[-1]) < float(vals[0]),
          f"overfitting one window, the loss falls: "
          f"{' '.join(f'{float(v):.4f}' for v in vals)}")

    # the carry on the kernel vs on the plain ops: the same forward, so the
    # same loss bit for bit, and the carry within the resample tolerance
    two = train_batch(CFG, device, 2, SEED + 1)
    carry = random_carry(2, CFG.ndepth, IMG_HW[0] // 4, IMG_HW[1] // 4,
                         device)
    before = kresample.launches
    on_kernel = step(train_state(CFG, device, weights), two, carry,
                     [True, True])
    n_kernel = read_launches()["resample"] - before
    plain = make_train_step(CFG, TRAIN, kernels=False)(
        train_state(CFG, device, weights), two, carry, [True, True])
    torch.cuda.synchronize()
    e = max_err(on_kernel.bv_predict, plain.bv_predict)
    check(n_kernel == 1 and torch.equal(on_kernel.loss, plain.loss)
          and within(on_kernel.bv_predict, plain.bv_predict,
                     *TOL["resample"]),
          f"2-lane train step, carry on the kernel ({n_kernel} launch) vs on "
          f"the plain ops: loss {float(on_kernel.loss):.6f} vs "
          f"{float(plain.loss):.6f}, carry max|err| {e:.3e}")
    launches["resample"] += n_kernel
    grads_vs_cpu(device)
    nondeterminism(device, weights)
    time_train_steps(device, weights)
    launches = {k: launches[k] + v
                for k, v in train_cli(loop_info, tmp).items()}
    return launches


def grads_vs_cpu(device) -> None:
    """One 2-lane step with a valid carry at SMALL on the card and on the
    CPU, from the same weights: every parameter's gradient."""
    state = {dev: train_state(SMALL, dev) for dev in ("cpu", device)}
    state["cpu"].model.load_state_dict(state[device].model.state_dict())
    carry = random_carry(2, SMALL.ndepth, SMALL_HW[0] // 4, SMALL_HW[1] // 4,
                         "cpu")
    out = {}
    for dev, st in state.items():
        out[dev] = make_train_step(SMALL, TRAIN)(
            st, train_batch(SMALL, dev, 2, SEED, SMALL_HW), carry.to(dev),
            [True, True])
    worst = {part: 0.0 for part in GRAD_TOL}
    cpu = dict(state["cpu"].model.named_parameters())
    for key, p in state[device].model.named_parameters():
        ref = cpu[key].grad
        part = key.split(".")[0]
        rel = float((p.grad.cpu() - ref).abs().max()) / (
            float(ref.abs().max()) + 1e-30)
        worst[part] = max(worst[part], rel)
    check(all(worst[p] <= GRAD_TOL[p] for p in GRAD_TOL),
          f"one train step at {SMALL_HW[1]}x{SMALL_HW[0]}, D={SMALL.ndepth}, "
          f"card vs CPU, max|grad diff| / max|grad| per tensor, worst by "
          f"module: " + ", ".join(f"{p} {v:.2e} (bound {GRAD_TOL[p]})"
                                  for p, v in worst.items())
          + f"; loss {float(out[device].loss):.6f} vs "
          f"{float(out['cpu'].loss):.6f}")


def nondeterminism(device, weights) -> None:
    """ROADMAP C2, repaired: two runs of the same 4 steps (2 lanes, the
    carry valid from step 2) from the same weights end equal bit for bit
    in every parameter, loss and carry (the check). Then the bisection
    that found the cause, each probe run twice on fixed inputs and
    compared with ``torch.equal``, and the step's ms with and without the
    repair (``ops.sampling.deterministic_backward``)."""
    batches = [train_batch(CFG, device, 2, SEED + 10 + t) for t in range(4)]

    def run():
        state = train_state(CFG, device, weights)
        step = make_train_step(CFG, TRAIN)
        carry, valid, losses = bv0_on(device).expand(2, -1, -1, -1), \
            [False, False], []
        for b in batches:
            out = step(state, b, carry, valid)
            carry, valid = out.bv_predict, [True, True]
            losses.append(out.loss)
        torch.cuda.synchronize()
        return state.model.state_dict(), torch.stack(losses).cpu(), carry

    (pa, la, ca), (pb, lb, cb) = run(), run()
    n_diff = sum(not torch.equal(pa[k], pb[k]) for k in pa)
    dp = max(float((pa[k] - pb[k]).abs().max()) for k in pa)
    check(n_diff == 0 and torch.equal(la, lb) and torch.equal(ca, cb)
          and bool(torch.isfinite(la).all()),
          f"{CARD[0]}: two identical runs of 4 train steps (C2): "
          f"{n_diff}/{len(pa)} parameter tensors differ (max|diff| "
          f"{dp:.3e}), losses equal {torch.equal(la, lb)}, final carry "
          f"equal {torch.equal(ca, cb)}")
    c2_probes(device, weights, batches[1])
    time_repair(device, weights)


@contextlib.contextmanager
def atomic_backward():
    """The train step as it was before the C2 repair: the card's own
    atomic-add backwards of ``F.grid_sample`` and ``F.interpolate``."""
    saved = train_step_mod.deterministic_backward
    train_step_mod.deterministic_backward = contextlib.nullcontext
    try:
        yield
    finally:
        train_step_mod.deterministic_backward = saved


def twice_equal(fn) -> str:
    """Run ``fn`` (returning {name: tensor}) twice; how many differ."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    n = sum(not torch.equal(a[k], b[k]) for k in a)
    dm = max(float((a[k] - b[k]).abs().max()) for k in a)
    return f"{n}/{len(a)} tensors differ (max|diff| {dm:.3e})"


def step_grads(device, weights, batch, cudnn: bool = True) -> dict:
    """The gradients of one 2-lane step (valid carry) from ``weights``."""
    state = train_state(CFG, device, weights)
    carry = random_carry(2, CFG.ndepth, IMG_HW[0] // 4, IMG_HW[1] // 4,
                         device)
    with torch.backends.cudnn.flags(enabled=cudnn):
        make_train_step(CFG, TRAIN)(state, batch, carry, [True, True])
    return {k: p.grad.clone() for k, p in state.model.named_parameters()}


def c2_probes(device, weights, batch) -> None:
    """The bisection of C2, each probe twice on fixed inputs: a whole step
    without the repair (as it was, with cuDNN disabled, and with
    CUBLAS_WORKSPACE_CONFIG set before a fresh process starts), then each
    module's backward alone, and the two repaired backwards."""
    print("  C2 bisection, each probe run twice on fixed inputs:", flush=True)
    with atomic_backward():
        print(f"    one 2-lane step's gradients, before the repair: "
              f"{twice_equal(lambda: step_grads(device, weights, batch))}; "
              f"cuDNN disabled for the whole step: "
              f"{twice_equal(lambda: step_grads(device, weights, batch, False))}",
              flush=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--c2-cublas-child"], env=env, timeout=300,
                           capture_output=True, text=True)
    print(f"    CUBLAS_WORKSPACE_CONFIG=:4096:8 in a fresh process, before "
          f"the repair: {child.stdout.strip() or child.stderr[-300:]}",
          flush=True)
    model = train_state(CFG, device, weights).model
    g = torch.Generator().manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device)

    def grads(module, loss_fn, fixed: bool = False):
        def fn():
            module.zero_grad(set_to_none=False)
            with step_mod.step_numerics(False), (
                    sampling.deterministic_backward() if fixed
                    else contextlib.nullcontext()):
                loss_fn().backward()
            return {k: p.grad.clone() for k, p in module.named_parameters()}
        return fn

    def input_grad(make, x0, fixed: bool = False):
        def fn():
            x = x0.clone().requires_grad_(True)
            with (sampling.deterministic_backward() if fixed
                  else contextlib.nullcontext()):
                make(x).backward()
            return {"input": x.grad}
        return fn

    fe = model.feature_extractor["feature_extraction"]
    frames, w1, wf = rnd(5, 3, *IMG_HW), rnd(5, 32, IMG_HW[0] // 2,
                                              IMG_HW[1] // 2), \
        rnd(5, CFG.feature_dim, IMG_HW[0] // 4, IMG_HW[1] // 4)

    def fe_loss():
        layer1, feat = fe(frames)
        return (layer1 * w1).sum() + (feat * wf).sum()

    src = rnd(CFG.n_views, 64, 96, CFG.feature_dim + 3)
    coords = sweep_inputs(device, translation_poses(device))[2]
    wg = rnd(CFG.n_views, CFG.ndepth, 64 * 96, CFG.feature_dim + 3)
    branch, wb = rnd(5, 32, 8, 12), rnd(5, 32, 64, 96)
    kv_in, wk = rnd(1, CFG.kvnet_in_channels, CFG.ndepth, 64, 96), \
        rnd(1, CFG.ndepth, 64, 96)
    rn_in = (torch.softmax(rnd(1, CFG.ndepth, 64, 96), 1),
             rnd(1, CFG.feature_dim, 64, 96), rnd(1, 32, 128, 192),
             rnd(1, 3, *IMG_HW))
    wr = rnd(1, CFG.ndepth, *IMG_HW)
    labels = torch.randint(0, CFG.ndepth, IMG_HW, generator=g).to(device)
    bn_x, bn_w = rnd(5, 128, 64, 96), rnd(5, 128, 64, 96)
    probes = {
        "feature extractor": grads(fe, fe_loss),
        "the sweep's F.grid_sample (V=4, D=64, 64x96, C=67)": input_grad(
            lambda x: (sampling.grid_sample_2d(x, coords) * wg).sum(), src),
        "bilinear F.interpolate (8x12 -> 64x96)": input_grad(
            lambda x: (layers_mod.upsample_bilinear_ac(x, (64, 96))
                       * wb).sum(), branch),
        "K-Net": grads(model.kv_net, lambda: (model.kv_net(kv_in)
                                              * wk).sum()),
        "R-Net": grads(model.r_net, lambda: (model.r_net(*rn_in)
                                             * wr).sum()),
        "nll_dpv_loss": input_grad(lambda x: nll_dpv_loss(
            torch.log_softmax(x, 0), labels), rnd(CFG.ndepth, *IMG_HW)),
    }
    for on in (True, False):
        bn = torch.nn.BatchNorm2d(128, track_running_stats=False,
                                  device=device)

        def bn_run(bn=bn, on=on):
            with torch.backends.cudnn.flags(enabled=on):
                return grads(bn, lambda: (bn(bn_x) * bn_w).sum())()
        probes[f"BatchNorm2d (5, 128, 64, 96), cuDNN "
               f"{'on' if on else 'off'}"] = bn_run
    probes["the sweep's F.grid_sample, fixed-order backward"] = input_grad(
        lambda x: (sampling.grid_sample_2d(x, coords) * wg).sum(), src, True)
    probes["bilinear F.interpolate, fixed-order backward"] = input_grad(
        lambda x: (layers_mod.upsample_bilinear_ac(x, (64, 96))
                   * wb).sum(), branch, True)
    probes["feature extractor, fixed-order backward"] = grads(fe, fe_loss,
                                                              True)
    for name, fn in probes.items():
        print(f"    {name}: {twice_equal(fn)}", flush=True)


def c2_cublas_child() -> None:
    """The ``--c2-cublas-child`` process: one 2-lane step's gradients twice
    without the repair, in a process whose CUBLAS_WORKSPACE_CONFIG was set
    before it started."""
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = train_state(CFG, device).model.state_dict()
    batch = train_batch(CFG, device, 2, SEED + 11)
    with atomic_backward():
        print(twice_equal(lambda: step_grads(device, weights, batch)))


def time_repair(device, weights) -> None:
    """ms per fp32 train step with and without the C2 repair, 1 and 2
    lanes, in turns (without, with, with, without)."""
    ms = {}
    for n in (1, 2):
        for fixed in (False, True, True, False):
            with (contextlib.nullcontext() if fixed else atomic_backward()):
                ms.setdefault((n, fixed), []).append(
                    train_step_ms(device, weights, CFG, n)[0])
    for n in (1, 2):
        before, after = ms[(n, False)], ms[(n, True)]
        print(f"  {CARD[0]}: fp32 train step, {n} lane(s), ms per step "
              f"(CUDA events over 5 steps), before the C2 repair "
              f"{' / '.join(f'{x:.2f}' for x in before)}, with it "
              f"{' / '.join(f'{x:.2f}' for x in after)} "
              f"({100 * (statistics.mean(after) / statistics.mean(before) - 1):+.1f}%)",
              flush=True)


def train_step_ms(device, weights, cfg, n: int, graph: bool = False):
    """(ms per step over 5 steps after 2 of warm-up, CUDA events; host ms
    to issue one (median); peak GiB; the last output; the step, state,
    batches and carry for more calls). ``graph``: the graphed step, whose
    key is captured in the first warm-up step."""
    state = train_state(cfg, device, weights)
    step = make_train_step(cfg, TRAIN, graph=graph)
    batches = [train_batch(cfg, device, n, SEED + 20 + t) for t in range(7)]
    carry = bv0_on(device).expand(n, -1, -1, -1).contiguous()
    for b in batches[:2]:
        carry = step(state, b, carry, [True] * n).bv_predict
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    host = []
    start.record()
    for b in batches[2:]:
        t = time.perf_counter()
        out = step(state, b, carry, [True] * n)
        host.append(1e3 * (time.perf_counter() - t))
        carry = out.bv_predict
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / len(batches[2:]),
            statistics.median(host),
            torch.cuda.max_memory_allocated() / 2 ** 30, out,
            (step, state, batches, carry))


def time_train_steps(device, weights) -> None:
    """ms per train step (CUDA events around 5 steps after 2 of warm-up,
    the carry valid), the host time to issue one, and the peak device
    memory, for 1 and 2 lanes, fp32 and bf16; then the host syncs of one
    2-lane fp32 step."""
    for name, cfg, n in (("fp32, 1 lane", CFG, 1), ("fp32, 2 lanes", CFG, 2),
                         ("bf16, 1 lane", BF16, 1),
                         ("bf16, 2 lanes", BF16, 2)):
        ms, host, peak, out, (step, state, batches, carry) = train_step_ms(
            device, weights, cfg, n)
        print(f"  {CARD[0]}: train step, {name}: {ms:.2f} ms per step "
              f"(CUDA events over 5 steps), host {host:.2f}"
              f" ms to issue one, peak device memory {peak:.2f} GiB, loss "
              f"{float(out.loss):.4f}", flush=True)
        check(bool(torch.isfinite(out.loss)), f"train step {name}: finite loss")
        if name == "fp32, 2 lanes":
            sites = sync_sites(lambda: step(state, batches[-1], carry,
                                            [True, True]))
            print(f"  host syncs in one 2-lane fp32 train step: "
                  f"{sum(sites.values())}", flush=True)
            for (where, message), k in sorted(sites.items()):
                print(f"    {k} x {where}: {message}", flush=True)
        del state, step, batches, carry, out
        torch.cuda.empty_cache()


def train_cli(loop_info: dict, tmp: str) -> dict:
    """``cli.train_kvnet`` for 3 steps on phase 14's scene at the operating
    point, then ``cli.test_kvnet --model_path`` on the checkpoint it wrote;
    returns the kernel launches of the training run."""
    root, save = loop_info["root"], os.path.join(tmp, "trained")
    argv = ["--exp_name", "smoke", "--dataset", "scannet", "--dataset_path",
            root, "--ndepth", str(CFG.ndepth), "--feature_dim",
            str(CFG.feature_dim), "--d_min", str(CFG.d_min), "--d_max",
            str(CFG.d_max), "--t_win", str(CFG.t_win_r), "--img_width",
            str(IMG_HW[1]), "--img_height", str(IMG_HW[0]), "--batch_size",
            "1", "--LR", str(TRAIN.lr), "--max_steps", "3", "--save_dir",
            save, "--log_dir", os.path.join(tmp, "runs"), "--device", "cuda"]
    reset_launches()
    t0 = time.perf_counter()
    state, out = quiet(cli_train_kvnet.main, argv)
    launches = read_launches()
    ckpt_dir = os.path.join(save, "smoke", "ckpt_00000003")
    check(state.step == 3 and os.listdir(os.path.join(save, "smoke"))
          == ["ckpt_00000003"] and launches["resample"] == 3,
          f"cli.train_kvnet: {state.step} steps in "
          f"{time.perf_counter() - t0:.1f} s, checkpoints "
          f"{os.listdir(os.path.join(save, 'smoke'))}, launches {launches}")
    res = os.path.join(tmp, "trained_test")
    _, out = quiet(cli_test_kvnet.main, loop_args(root, ckpt_dir, res))
    n = len(state.model.state_dict())
    check(f"loaded {n} tensors from {ckpt_dir}" in out,
          f"cli.test_kvnet --model_path {os.path.basename(ckpt_dir)}: every "
          f"one of the {n} tensors loaded")
    check_contract(os.path.join(res, "loop_0"))
    served = KVNet(CFG, device=next(state.model.parameters()).device,
                   seed=SEED + 1, single_refine=True)
    restore_params_partial(ckpt_dir, served)
    trained = state.model.state_dict()
    check(all(torch.equal(v, trained[k])
              for k, v in served.state_dict().items()),
          "the checkpoint holds the trained weights")
    return launches


def write_kitti_drive(root: str, n_frames: int) -> str:
    """A KITTI raw drive (calibration, 1242x375 colour frames, OXTS packets
    driving east) with projected-depth ground truth; the layout of
    tests/test_kitti.py. Returns the depth root."""
    W, H = 1242, 375
    date = "2011_09_26"
    drive = os.path.join(root, date, f"{date}_drive_0001_sync")
    gt = os.path.join(root, "depth", "train", f"{date}_drive_0001_sync",
                      "proj_depth", "groundtruth", "image_02")
    for d in ("image_02/data", "oxts/data"):
        os.makedirs(os.path.join(drive, d))
    os.makedirs(gt)
    with open(os.path.join(root, date, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"S_rect_02: {W} {H}\nR_rect_00: 1 0 0 0 1 0 0 0 1\n"
                f"P_rect_02: 721.5 0 609.6 -337.0 0 721.5 172.9 0 0 0 1 0\n")
    with open(os.path.join(root, date, "calib_velo_to_cam.txt"), "w") as f:
        f.write("R: 0 -1 0 0 0 -1 1 0 0\nT: 0.27 0.0 -0.08\n")
    with open(os.path.join(root, date, "calib_imu_to_velo.txt"), "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: -0.8 0.3 0.8\n")
    import PIL.Image

    rng = np.random.RandomState(SEED)
    for i in range(n_frames):
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        PIL.Image.fromarray(img).save(
            os.path.join(drive, "image_02", "data", f"{i:010d}.png"))
        depth = rng.uniform(2.0, 50.0, (H, W))
        depth[rng.rand(H, W) < 0.7] = 0.0
        PIL.Image.fromarray((depth * 256).astype(np.uint16)).save(
            os.path.join(gt, f"{i:010d}.png"))
        row = np.zeros(30)
        row[:3] = 49.0, 8.43 + i * 1e-5, 112.0
        row[5] = 0.1
        np.savetxt(os.path.join(drive, "oxts", "data", f"{i:010d}.txt"),
                   row[None])
    return os.path.join(root, "depth")


def phase_kitti(device, tmp: str, errs: dict) -> dict:
    W, H = KITTI_WH
    print(f"phase 20: KITTI at no-crop {W}x{H} ({W // 4}x{H // 4} DPV grid): "
          f"a fabricated {KITTI_FRAMES}-frame drive at 1242x375", flush=True)
    root = os.path.join(tmp, "kitti")
    depth_root = write_kitti_drive(root, KITTI_FRAMES)
    traj = kitti.make_trajectory(0, root, depth_gt_root=depth_root,
                                 img_size_wh=KITTI_WH, crop_w=None,
                                 d_candi=KITTI_CFG.d_candi)
    check(traj.dpv_size_wh == (W // 4, H // 4) and len(traj) ==
          KITTI_FRAMES - 10, f"the drive: {len(traj)} frames, DPV grid "
          f"{traj.dpv_size_wh}")

    # the two kernels against their twins at the KITTI shapes
    win, _, _ = window_batch(traj, CFG.t_win_r, CFG.t_win_r)
    poses = torch.from_numpy(win["poses"][0]).to(device)
    cam = camera_from_K(traj.K_dpv, device)
    d = torch.as_tensor(KITTI_CFG.d_candi, device=device)
    g = torch.Generator().manual_seed(SEED)
    C = CFG.feature_dim + 3
    ref = torch.randn(H // 4, W // 4, C, generator=g).to(device)
    srcs = torch.randn(CFG.n_views, H // 4, W // 4, C, generator=g).to(device)
    coords = _sweep_pixel_coords(cam, poses[:, :3, :3], poses[:, :3, 3], d,
                                 H // 4, W // 4)
    cost, kept = ksweep.sweep_kernel(planar(ref), planar(srcs), coords,
                                     CFG.sigma_soft_max, "L2", 3)
    pcost, pkept = ksweep.sweep_plain(ref, srcs, coords, CFG.sigma_soft_max,
                                      "L2", 3)
    e_cost, e_kept = max_err(cost, pcost), max_err(kept, pkept)
    errs["sweep_fused"].append(max(e_cost, e_kept))
    check(within(cost, pcost, *TOL["cost"]) and within(kept, pkept,
                                                       *TOL["kept"]),
          f"sweep kernel at V=4 D=64 {H // 4}x{W // 4} C={C}, the drive's "
          f"poses: max|cost err| {e_cost:.3e}, max|kept err| {e_kept:.3e}")
    lv = random_carry(1, CFG.ndepth, H // 4, W // 4, device)
    args = (lv, torch.from_numpy(win["pose_next"]).to(device),
            torch.from_numpy(win["K"]).to(device), d, -math.log(CFG.ndepth))
    got, want = kresample.predict_next_cuda(*args), \
        kresample.predict_next_plain(*args)
    e = max_err(got, want)
    errs["resample"].append(e)
    check(within(got, want, *TOL["resample"]),
          f"resample kernel at (64, {H // 4}, {W // 4}), the drive's "
          f"pose_next: max|err| {e:.3e}")

    # the loop through the CLI at no-crop: --crop_w equal to --img_width
    model = KVNet(KITTI_CFG, device=device, seed=SEED, single_refine=True)
    ckpt = os.path.join(tmp, "kitti.tar")
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()}}, ckpt)
    argv = ["--dataset", "kitti", "--dataset_path", root, "--model_path",
            ckpt, "--res_dir", os.path.join(tmp, "kitti_out"), "--exp_name",
            "kitti", "--ndepth", str(CFG.ndepth), "--feature_dim",
            str(CFG.feature_dim), "--d_min", str(KITTI_CFG.d_min), "--d_max",
            str(KITTI_CFG.d_max), "--t_win", str(CFG.t_win_r),
            "--img_width", str(W), "--img_height", str(H), "--crop_w", str(W),
            "--device", "cuda"]
    reset_launches()
    with StepProbe(loop_mod) as probe:
        quiet(cli_test_kvnet.main, argv)
    launches = read_launches()
    check(launches == expected_launches(T_KITTI, T_KITTI,
                                        knet=T_KITTI - 1),
          f"launches in the KITTI loop: {launches} (expected {T_KITTI} "
          f"sweeps and {T_KITTI} resamples at {W // 4} wide, the extractor "
          f"at {W}x{H})")
    out_dir = os.path.join(tmp, "kitti_out", "kitti_0")
    files = sorted(os.listdir(out_dir))
    check(len(files) == 3 * T_KITTI + 1 and read_pgm(os.path.join(
        out_dir, "d_00000.pgm")).shape == (H, W),
          f"the export contract: {len(files)} files for {T_KITTI} frames at "
          f"{W}x{H}")
    frame = probe.frame_ms()[1:]
    print(f"  {CARD[0]}: the KITTI loop at {W}x{H}, ms per frame (median of "
          f"frames 2..{T_KITTI - 1}, CUDA events after each step): "
          f"{statistics.median(frame):.3f}; per frame "
          f"{' '.join(f'{x:.1f}' for x in frame)}", flush=True)
    keys = ("ref", "srcs", "poses", "K", "pose_next")
    wins = [window_batch(traj, r, CFG.t_win_r)[0]
            for r in range(CFG.t_win_r, CFG.t_win_r + T_KITTI)]
    windows = {k: torch.from_numpy(np.stack([b[k] for b in wins])).to(device)
               for k in keys}
    depth, conf, _ = make_rollout(KITTI_CFG)(
        model, windows, uniform_dpv(CFG.ndepth, H // 4, W // 4, device)[None],
        [False])
    diff = 0
    for name, maps in (("d", depth), ("conf", conf)):
        for t in range(T_KITTI):
            want = loop_mod._q16(maps[t, 0]).cpu().numpy().view(np.uint16)
            got = read_pgm(os.path.join(out_dir, f"{name}_{t:05d}.pgm"))
            diff = max(diff, int(np.abs(got.astype(np.int64)
                                        - want.astype(np.int64)).max()))
    check(diff == 0, f"all {T_KITTI} frames' maps equal the rollout's on the "
          f"same windows: max |diff| {diff} unit(s)")

    # two train steps on the drive's labelled windows at no-crop
    state = create_train_state(KITTI_CFG, TRAIN, model=KVNet(
        KITTI_CFG, device=device, seed=SEED))
    step = make_train_step(KITTI_CFG, TRAIN)
    carry, valid = uniform_dpv(CFG.ndepth, H // 4, W // 4, device)[None], \
        [False]
    reset_launches()
    for ref_idx in (CFG.t_win_r, CFG.t_win_r + 1):
        b, _, ok = window_batch(traj, ref_idx, CFG.t_win_r, with_labels=True)
        out = step(state, upload_batch(b, device), carry, valid)
        carry, valid = out.bv_predict, [ok]
    train_launches = read_launches()
    check(train_launches["resample"] == 2 and bool(torch.isfinite(out.loss))
          and carry.shape[-1] == W // 4,
          f"2 train steps on the drive at no-crop: loss "
          f"{float(out.loss):.4f}, launches {train_launches}")
    return {k: launches[k] + train_launches[k] for k in launches}


def write_capture(root: str) -> dict:
    """A single-folder capture: ``write_scannet_scene``'s frames at
    640x480, its intrinsics as a ``.json`` and a DSO ``result.txt`` from
    its cam-to-world poses at a monocular scale (their translations times
    LBA_DSO_SCALE) with a visual-odometry track's error (seeded noise of
    1e-3 on each translation and 1e-4 on each quaternion component), so no
    pose is exactly the identity ('DSO did not return') and no relative
    translation has an exact zero. On exact zeros see PERF.md, PR 9: a
    pixel whose depth regresses to exactly 0 then divides 0 by 0 in the
    warp, in JAX as here."""
    scene = write_scannet_scene(root, n_frames=LBA_FRAMES)
    intrin = os.path.join(root, "cam_info.json")
    with open(intrin, "w") as f:
        json.dump({"IntM": [[585.0, 0, 323.7], [0, 585.0, 237.9], [0, 0, 1]],
                   "img_size": [640, 480]}, f)
    rng = np.random.RandomState(SEED)
    lines = []
    for i in range(LBA_FRAMES):
        c2w = np.loadtxt(os.path.join(scene, f"frame-{5 * i:06d}.pose.txt"))
        q = rotation_to_quat(torch.from_numpy(c2w[:3, :3])).numpy() \
            + rng.normal(0.0, 1e-4, 4)
        t = c2w[:3, 3] * LBA_DSO_SCALE + rng.normal(0.0, 1e-3, 3)
        lines.append(f"{i} " + " ".join(f"{x:.9g}" for x in (*t, *q)))
    result = os.path.join(root, "result.txt")
    with open(result, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"img_glob": os.path.join(scene, "*.color.jpg"),
            "intrin_path": intrin, "dso_res_path": result}


def lba_problem(V: int = 4) -> tuple:
    """tests/test_pose.py's smooth problem at the operating point, V views,
    on the CPU: ref := the source warped at a constant 2 m by t_true; each
    view's init t_true perturbed by up to 3 cm. Returns (the intrinsics of
    the 3 scales, the program's arguments, t_true)."""
    H, W = IMG_HW
    Ks = [np.array([[240.0 / s, 0, W / s / 2], [0, 240.0 / s, H / s / 2],
                    [0, 0, 1]], np.float32) for s in (4, 2, 1)]
    rng = np.random.RandomState(SEED)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    src = np.stack([np.sin(xs / 28.0 + c) + np.cos(ys / 20.0 - c)
                    for c in range(3)], -1) + 0.1 * rng.rand(H, W, 3)
    src = torch.from_numpy(src.astype(np.float32))
    dmap = torch.full((H, W), 2.0)
    t_true = torch.tensor([0.06, -0.03, 0.02])
    ref = backward_warp_by_depth(src[None], dmap, torch.eye(3)[None],
                                 t_true[None], camera_from_K(Ks[-1]))[0]
    inits = torch.eye(4).repeat(V, 1, 1)
    inits[:, :3, 3] = t_true + torch.from_numpy(
        rng.uniform(-0.03, 0.03, (V, 3)).astype(np.float32))
    return Ks, (ref, src.expand(V, H, W, 3).contiguous(), dmap,
                torch.ones_like(dmap), inits), t_true


def phase_lba(device, loop_info: dict, tmp: str, errs: dict) -> dict:
    H, W = IMG_HW
    print(f"phase 21: the pose-free LBA pipeline at {W}x{H}, D={CFG.ndepth}, "
          f"feature_dim {CFG.feature_dim}, t_win {CFG.t_win_r}, "
          f"{LBA_ITERS} LBA iterations x 3 scales", flush=True)
    # B3: the image-resolution resample of make_lba_maps against its twin
    lv = random_carry(1, CFG.ndepth, H, W, device)[0]
    pose = torch.from_numpy(_pose_next("roll 3 deg")).to(device)
    cam = camera_from_K(_K(H, W), device)
    d = torch.as_tensor(CFG.d_candi, device=device)
    pad = math.log(1.0 / CFG.ndepth)
    rel = kresample.adjugate_inverse(pose)
    got = kresample.resample_dpv_cuda(lv, rel, cam, d, pad)
    want = kresample.resample_plain(lv[None], rel[None], cam.K[None], d,
                                    False, pad)[0]
    torch.cuda.synchronize()
    e = max_err(got, want)
    errs["resample"].append(e)
    check(torch.equal(got, want), f"B3 resample_dpv_cuda at ({CFG.ndepth}, "
          f"{H}, {W}) vs its twin: bit for bit {torch.equal(got, want)} "
          f"(max|err| {e:.3e})")

    # the LBA program: card vs CPU on a smooth recovery problem (t only,
    # as tests/test_pose.py recovers it), and the CLI's program twice
    Ks, cpu_args, t_true = lba_problem()
    args = [a.to(device) for a in cpu_args]
    recover = {dev: make_lba_program([camera_from_K(K, dev) for K in Ks],
                                     max_iter=LBA_ITERS, opt_vars=(0, 1))
               for dev in ("cpu", device)}
    out = recover[device](*args).cpu()
    cpu = recover["cpu"](*cpu_args)
    err0 = (cpu_args[-1][:, :3, 3] - t_true).norm(dim=1)
    err1 = (out[:, :3, 3] - t_true).norm(dim=1)
    check(within(out, cpu, 1e-4, 2e-4) and bool((err1 < 0.4 * err0).all()),
          f"the LBA program (V=4, t only) on the card vs the CPU: max|diff| "
          f"{max_err(out, cpu):.3e} (rtol 1e-4, atol 2e-4, JAX's bound "
          f"between its builds); |t - t_true| from "
          f"{[round(float(x), 4) for x in err0]} to "
          f"{[round(float(x), 4) for x in err1]} m")
    run = make_lba_program([camera_from_K(K, device) for K in Ks],
                           max_iter=LBA_ITERS)
    first, again = run(*args), run(*args)
    check(torch.equal(first, again), "the CLI's LBA program (R and t), two "
          f"runs on the card: equal bit for bit {torch.equal(first, again)}")
    lba_ms = host_ms(lambda: run(*args), reps=5)
    n_launch = kernel_launches(lambda: run(*args))
    print(f"  {CARD[0]}: the LBA program (V=4, {LBA_ITERS} x 3 iterations) "
          f"{lba_ms:.2f} ms a frame (host clock to a sync), {n_launch} "
          f"kernel launches a frame ({n_launch / (3 * LBA_ITERS):.1f} an "
          f"iteration)", flush=True)

    # the CLI on a fabricated capture, through both pose-graph arms. The
    # warp divides by z with no epsilon, as JAX and the reference do: a
    # pixel whose z rounds to exactly 0 makes that view's pose NaN (PERF.md,
    # PR 9). The host arm's gate then skips the windows that hold it (as
    # JAX's), the device arm goes on (as JAX's), and both are counted.
    cap = write_capture(os.path.join(tmp, "capture"))
    n_frames = LBA_FRAMES - 2 * CFG.t_win_r - 1
    outs, launches_all = {}, {k: 0 for k in KERNELS}
    for arm in ("host", "device"):
        calls = {"B3": 0}
        real = kresample.resample_dpv_cuda

        def counted(*a, **k):
            calls["B3"] += 1
            return real(*a, **k)

        kresample.resample_dpv_cuda = counted
        reset_launches()
        try:
            n, text = quiet(cli_lba.main, lba_args(cap, loop_info, tmp, arm)
                            + ["--no_graph"])
        finally:
            kresample.resample_dpv_cuda = real
        launches = read_launches()
        for k in launches:
            launches_all[k] += launches[k]
        out_dir = os.path.join(tmp, f"lba_{arm}", "lba")
        skipped = text.count("invalid DSO pose, skipped")
        timing = [x for x in text.splitlines() if x.startswith("TIMING")]
        poses = np.load(os.path.join(out_dir, "poses.npz"))
        finite = np.isfinite(poses["extMs"]).all(axis=(1, 2))
        files = set(os.listdir(out_dir))
        want = {f"{p}_{i:05d}.{ext}" for i in range(n)
                for p, ext in (("img", "png"), ("d", "pgm"), ("conf", "pgm"))}
        rows = open(os.path.join(out_dir, "scene_path_info.txt")).read() \
            .splitlines()
        d_max = max(int(read_pgm(os.path.join(out_dir, f"d_{i:05d}.pgm"))
                        .max()) for i in range(n))
        gated = [int(x.split()[1][:-1]) for x in text.splitlines()
                 if x.endswith("invalid DSO pose, skipped")]
        outs[arm] = (min(gated, default=LBA_FRAMES), out_dir, rows[1:])
        check(n == n_frames - skipped and (arm == "host" or skipped == 0)
              and files == want | {"scene_path_info.txt", "poses.npz"}
              and len(rows) == n + 1 and poses["extMs"].shape ==
              (LBA_FRAMES, 4, 4) and (poses["valid"] == finite).all()
              and d_max <= 1000 * CFG.d_max and len(timing) == 1,
              f"cli.test_kvnet_lba --pose_graph {arm}: {n} frames "
              f"({skipped} windows skipped by the pose gate), {len(files)} "
              f"files, {len(rows) - 1} scene_path_info rows, poses.npz "
              f"{poses['extMs'].shape}: {int(finite.sum())} finite, all "
              f"valid ones; max depth {d_max}")
        b2 = launches["resample"] - calls["B3"]
        check(launches["sweep_fused"] == n and b2 == n and calls["B3"] == n
              and launches["conv2d_bn"] == FE_LAUNCHES * n,
              f"{arm} arm launches: B1 (sweep) {launches['sweep_fused']}, B2 "
              f"(predict_next) {b2}, B3 (resample_dpv_cuda) {calls['B3']} "
              f"for {n} frames (1 each a frame); the extractor's conv2d_bn "
              f"{launches['conv2d_bn']} ({FE_LAUNCHES} a frame)")
        print(f"  {CARD[0]}: {arm} arm {timing[0] if timing else 'no TIMING'}",
              flush=True)
        loop_info.setdefault("lba", {"cap": cap})[arm] = (n, out_dir, timing)
    # the arms frame by frame while both chains are finite: up to the host
    # arm's first gated window, and up to the device arm's first frame
    # with a NaN depth (its pgm reads 0 there; a regressed depth is at
    # least d_min otherwise)
    (gate, host_dir, host_rows), (_, dev_dir, dev_rows) = outs["host"], \
        outs["device"]
    dev_index = {r.split("  ")[1]: int(r.split("  ")[0]) for r in dev_rows}
    worst, first, shared = 1.0, 0, 0
    for row in host_rows[:gate - CFG.t_win_r]:
        i, path = int(row.split("  ")[0]), row.split("  ")[1]
        maps = {(arm, p): read_pgm(os.path.join(
            out, f"{p}_{k:05d}.pgm")).astype(np.int64)
            for arm, out, k in (("host", host_dir, i),
                                ("device", dev_dir, dev_index[path]))
            for p in ("d", "conf")}
        if not maps[("device", "d")].min():
            break
        shared += 1
        for p in ("d", "conf"):
            diff = np.abs(maps[("host", p)] - maps[("device", p)])
            if i == 0:
                first = max(first, int(diff.max()))
            else:
                worst = min(worst, float((diff <= 2).mean()))
    check(shared >= 1 and first <= 1 and worst >= 0.95,
          f"device arm vs host arm on the {shared} frames where both chains "
          f"are finite: "
          f"frame 0 max |diff| {first} unit(s); later frames' worst share "
          f"within 2 units {worst:.4f} (chaos floor 0.95, "
          f"tests/test_lba_cli.py)")

    # host syncs per steady device-arm frame: two runs that differ by
    # SYNC_FRAMES steady frames
    counts = []
    for last in (CFG.t_win_r + 1 + 1, CFG.t_win_r + 1 + 1 + SYNC_FRAMES):
        sites = sync_sites(lambda: quiet(cli_lba.main, lba_args(
            cap, loop_info, tmp, "device", f"sync{last}")
            + ["--max_frame_idx", str(last), "--no_graph"]))
        counts.append(sum(sites.values()))
    per_frame = (counts[1] - counts[0]) / SYNC_FRAMES
    check(per_frame == 0, f"host syncs per steady device-arm frame: "
          f"{per_frame} (runs of {counts} syncs in all, {SYNC_FRAMES} "
          f"steady frames apart)")
    for (where, message), k in sorted(sites.items()):
        print(f"    {k} x {where}: {message}", flush=True)
    return launches_all


def lba_args(cap: dict, loop_info: dict, tmp: str, arm: str,
             name: str = "") -> list[str]:
    """``cli.test_kvnet_lba`` at the operating point on ``cap``."""
    return ["--img_glob", cap["img_glob"], "--intrin_path",
            cap["intrin_path"], "--dso_res_path", cap["dso_res_path"],
            "--model_path", loop_info["ckpt"], "--exp_name", "lba",
            "--res_dir", os.path.join(tmp, f"lba_{name or arm}"),
            "--ndepth", str(CFG.ndepth), "--feature_dim",
            str(CFG.feature_dim), "--d_min", str(CFG.d_min), "--d_max",
            str(CFG.d_max), "--t_win", str(CFG.t_win_r), "--img_width",
            str(IMG_HW[1]), "--img_height", str(IMG_HW[0]),
            "--LBA_max_iter", str(LBA_ITERS), "--pose_graph", arm,
            "--save_poses", "--timing", "--device", "cuda"]


def head_cfg(name: str) -> ModelConfig:
    return dataclasses.replace(CFG, **HEADS[name])


def phase_heads(model, device, loop_info: dict, tmp: str) -> dict:
    print(f"phase 22: the remaining heads, T={T} at {IMG_HW[1]}x{IMG_HW[0]} "
          f"(D={CFG.ndepth}, V={CFG.n_views}, feature_dim "
          f"{CFG.feature_dim}, fp32, seeded weights)", flush=True)
    launches = {k: 0 for k in KERNELS}
    frames = frames_on(device, T)
    models, exact = {}, {}
    for name in HEADS:
        cfg = head_cfg(name)
        models[name] = head = KVNet(cfg, device=device, seed=SEED,
                                    single_refine=True)
        print(f"  {name}:", flush=True)
        torch.cuda.reset_peak_memory_stats()
        got, depth, conf = check_rollout(
            head, frames,
            expected_launches(T, T, knet=knet_steps(T - 1, cfg)), cfg=cfg)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in KERNELS:
            launches[k] += got[k]
        exact[name] = depth
        again = make_rollout(cfg)(head, frames, bv0_on(device), [False])
        check(all(torch.equal(a, b) for a, b in zip((depth, conf), again)),
              f"{name}: two kernel-path rollouts equal bit for bit")
        pdepth, pconf, _ = make_rollout(cfg, kernels=False)(
            head, frames, bv0_on(device), [False])
        for what, a, b in (("depth", depth, pdepth),
                           ("confidence", conf, pconf)):
            e, mean = max_err(a, b), float((a - b).abs().mean())
            by_mean = name == "DGF" and what == "depth"
            check(mean <= DGF_DEPTH_MEAN if by_mean
                  else e <= ROLLOUT_TOL[what],
                  f"{name}: kernel path vs plain path, {what}: max|err| "
                  f"{e:.3e}, mean {mean:.3e} over {T} frames "
                  f"({'mean' if by_mean else 'max'} held)")
        step = make_infer_step(cfg)
        first = step(head, {k: v[0] for k, v in frames.items()},
                     bv0_on(device), [False])
        sites = sync_sites(lambda: step(
            head, {k: v[1] for k, v in frames.items()}, first.bv_predict,
            [True]))
        check(not sites, f"{name}: host syncs in one steady kernel-path "
              f"step: {sum(sites.values())} {list(sites)[:3]}")
        print(f"  {CARD[0]}: {name} rollout peak device memory "
              f"{peak:.2f} GiB", flush=True)

    # the DGF head on the card vs the CPU, first 2 frames: depth mean and max
    cpu = KVNet(head_cfg("DGF"), device="cpu", single_refine=True)
    cpu.load_state_dict(models["DGF"].state_dict())
    cdepth, _, _ = make_rollout(head_cfg("DGF"))(
        cpu, {k: v[:2].cpu() for k, v in frames.items()}, bv0_on("cpu"),
        [False])
    diff = (exact["DGF"][:2].cpu() - cdepth).abs()
    check(float(diff.max()) <= ROLLOUT_TOL["depth"],
          f"DGF card vs CPU, first 2 frames, depth: max|err| "
          f"{float(diff.max()):.3e} m, mean {float(diff.mean()):.3e} m")

    # fast_knet under refine_costv: the conv kernel, 10 launches a fused frame
    cfg = head_cfg("refine_costv")
    got, fdepth, _ = check_rollout(
        models["refine_costv"], frames,
        expected_launches(T, T, 10 * (T - 1)), cfg=cfg, fast_knet=True)
    for k in KERNELS:
        launches[k] += got[k]
    dev = float((fdepth - exact["refine_costv"]).abs().mean())
    check(dev < FAST_DEPTH_MEAN,
          f"refine_costv with fast_knet vs the exact path: mean |depth "
          f"difference| {dev:.3e} m (< {FAST_DEPTH_MEAN})")

    # ms per frame of each head beside the default head, in turns
    paths = {"DPV (phase 5)": (model, CFG)}
    paths.update({n: (models[n], head_cfg(n)) for n in HEADS})
    times = {n: [] for n in paths}
    for _ in range(2):
        for n, (m, c) in paths.items():
            times[n].append(statistics.median(frame_ms(m, device, True,
                                                       cfg=c)[1:]))
    for n, ts in times.items():
        print(f"  {CARD[0]}: {n}: {' / '.join(f'{t:.3f}' for t in ts)} ms "
              f"per frame (CUDA events, median of frames 2 on, two turns)",
              flush=True)
    time_rnet_dup(device)

    # the test CLI with DGF on phase 14's scene, from a reference-style .tar
    ckpt = os.path.join(tmp, "dgf.tar")
    torch.save({"state_dict": {f"module.{k}": v.cpu() for k, v in
                               models["DGF"].state_dict().items()}}, ckpt)
    got = cli_flag_run(models["DGF"], loop_info, tmp, "cli_dgf",
                       ["--refine_net", "DGF"], cfg=head_cfg("DGF"),
                       ckpt=ckpt)
    for k in KERNELS:
        launches[k] += got[k]
    del models, exact
    for k, n in train_heads(device, loop_info, tmp).items():
        launches[k] += n
    legacy_heads(device)
    return launches


def rnet_flops(D: int, dup: bool, C0: int = 64, C1: int = 32, C2: int = 3,
               h: int = IMG_HW[0] // 4, w: int = IMG_HW[1] // 4) -> float:
    """Multiply-adds x 2 of one R-Net pass (``models/rnet.py``): 3x3 convs
    2*9*Cin*Cout per output pixel, the k=4 s=2 transposed convs 2*16*Cin*Cout
    per input pixel."""
    D0 = 2 * D if dup else D
    D1 = 2 * D0 if dup else D
    c0, c1, c2 = D + C0, D0 + C1, D1 + C2
    px0, px1, px2 = h * w, 4 * h * w, 16 * h * w
    return 2 * (9 * 2 * c0 * c0 * px0 + 16 * c0 * D0 * px0
                + 9 * 2 * c1 * c1 * px1 + 16 * c1 * D1 * px1
                + 9 * (c2 * c2 + c2 * D1 + D1 * D1) * px2)


def time_rnet_dup(device) -> None:
    """One R-Net pass at the operating point, default and ``refine_dup``:
    CUDA events over 10 passes, beside its fp32 operations bound."""
    g = torch.Generator().manual_seed(SEED)
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    for dup in (False, True):
        rnet = RNet(D=CFG.ndepth, C0=CFG.feature_dim, device=device,
                    upsample_D=dup)
        layers_mod.reference_init_(rnet, SEED)
        args = [torch.rand(1, CFG.ndepth, h, w, generator=g),
                torch.randn(1, CFG.feature_dim, h, w, generator=g),
                torch.randn(1, 32, 2 * h, 2 * w, generator=g),
                torch.randn(1, 3, *IMG_HW, generator=g)]
        args = [a.to(device) for a in args]
        with torch.no_grad(), step_mod.step_numerics(False):
            for _ in range(2):
                rnet(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                out = rnet(*args)
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 10
        flops = rnet_flops(CFG.ndepth, dup)
        b_ms, by = bound(4 * sum(a.numel() for a in args) + 4 * out.numel(),
                         flops, "fp32")
        print(f"  {CARD[0]}: R-Net {'refine_dup' if dup else 'default'} "
              f"pass, out {tuple(out.shape)}: {ms:.3f} ms, "
              f"{flops / 1e9:.1f} GFLOP fp32, bound {b_ms:.3f} ms "
              f"({by}), {flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def train_heads(device, loop_info: dict, tmp: str) -> dict:
    """``make_train_step`` for 3 steps at 1 lane, fp32, under each trainable
    head, twice from the same weights; then ``cli.train_kvnet
    --refine_dup``. Returns the kernel launches."""
    launches = {k: 0 for k in KERNELS}
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    for name in ("refine_dup", "dnet_bayes", "refine_costv"):
        cfg = head_cfg(name)
        step = make_train_step(cfg, TRAIN)
        batch = train_batch(cfg, device, 1, SEED + 2)
        carry = random_carry(1, CFG.ndepth, h, w, device)
        weights = {k: v.clone() for k, v in
                   KVNet(cfg, device=device, seed=SEED).state_dict().items()}
        runs = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            state = train_state(cfg, device, weights)
            reset_launches()
            losses, ms, carries = [], [], []
            for _ in range(TRAIN_HEAD_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch, carry, [True])
                end.record()
                losses.append(out.loss)
                carries.append(out.bv_predict)
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            got = read_launches()
            runs.append((state.model.state_dict(), torch.stack(losses),
                         torch.stack(carries), ms, got))
            del state
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (p1, l1, c1, _, n1), (p2, l2, c2, ms, _) = runs
        for k in KERNELS:
            launches[k] += n1[k] + runs[1][4][k]
        vals = l1.cpu()
        check(bool(torch.isfinite(vals).all()) and float(vals[-1])
              < float(vals[0])
              and n1 == expected_launches(0, TRAIN_HEAD_STEPS),
              f"{name} training, one window with a valid carry: losses "
              f"{' '.join(f'{float(v):.4f}' for v in vals)} (finite, "
              f"falling), launches {n1}")
        differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        check(not differ and torch.equal(l1, l2) and torch.equal(c1, c2),
              f"{name}: two {TRAIN_HEAD_STEPS}-step runs equal bit for bit "
              f"({len(differ)} of {len(p1)} tensors differ; losses and "
              f"carry {'equal' if torch.equal(l1, l2) and torch.equal(c1, c2) else 'differ'})")
        print(f"  {CARD[0]}: {name} train step, fp32, 1 lane: "
              f"{statistics.median(ms[1:]):.2f} ms (CUDA events, median of "
              f"steps 2 on; {' / '.join(f'{t:.2f}' for t in ms)}), peak "
              f"device memory {peak:.2f} GiB", flush=True)
        del runs, p1, p2, weights
    root, save = loop_info["root"], os.path.join(tmp, "trained_dup")
    argv = ["--exp_name", "dup", "--dataset", "scannet", "--dataset_path",
            root, "--ndepth", str(CFG.ndepth), "--feature_dim",
            str(CFG.feature_dim), "--d_min", str(CFG.d_min), "--d_max",
            str(CFG.d_max), "--t_win", str(CFG.t_win_r), "--img_width",
            str(IMG_HW[1]), "--img_height", str(IMG_HW[0]), "--batch_size",
            "1", "--LR", str(TRAIN.lr), "--max_steps", "2", "--save_dir",
            save, "--log_dir", os.path.join(tmp, "runs_dup"),
            "--refine_dup", "--device", "cuda"]
    reset_launches()
    t0 = time.perf_counter()
    state, _ = quiet(cli_train_kvnet.main, argv)
    got = read_launches()
    for k in KERNELS:
        launches[k] += got[k]
    check(state.step == 2 and os.listdir(os.path.join(save, "dup"))
          == ["ckpt_00000002"] and got["resample"] == 2
          and state.model.r_net.conv2_2.weight.shape[0] == 4 * CFG.ndepth,
          f"cli.train_kvnet --refine_dup: {state.step} steps in "
          f"{time.perf_counter() - t0:.1f} s on the up4 labels, "
          f"checkpoints {os.listdir(os.path.join(save, 'dup'))}, "
          f"launches {got}")
    return launches


def legacy_heads(device) -> None:
    """The six legacy refine heads on the card vs the CPU, the same seeded
    weights and inputs, fp32 (TF32 off since phase 1), at the DPV grid."""
    g = torch.Generator().manual_seed(SEED)
    h, w = IMG_HW[0] // 4, IMG_HW[1] // 4
    img = torch.randn(1, 3, *IMG_HW, generator=g)
    vol = torch.randn(1, 1, CFG.ndepth, h, w, generator=g)
    img_vol = torch.randn(1, 3, CFG.ndepth, h, w, generator=g)
    cases = {
        "unet2d": (lambda d: legacy.RefineNetUnet2D(7, device=d),
                   (torch.randn(1, 4, h, w, generator=g), img)),
        "demon": (lambda d: legacy.RefineNetDeMoN(3, device=d),
                  (CFG.d_max * torch.rand(1, 1, h, w, generator=g), img)),
        "3d": (lambda d: legacy.RefineNet3D(4, True, device=d),
               (vol, img_vol)),
        "3d_nearest": (lambda d: legacy.RefineNet3D(4, False, device=d),
                       (vol, img_vol)),
        "unet3d_res": (lambda d: legacy.RefineNetUNet3D(4, True, device=d),
                       (vol, img_vol)),
        "unet3d": (lambda d: legacy.RefineNetUNet3D(4, False, device=d),
                   (vol, img_vol)),
    }
    for name, (make, ins) in cases.items():
        card = layers_mod.reference_init_(make(device), SEED)
        cpu = make("cpu")
        cpu.load_state_dict(card.state_dict())
        on_card = [x.to(device) for x in ins]
        with torch.no_grad():
            want = cpu(*ins)
            got = card(*on_card)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                card(*on_card)
            end.record()
            torch.cuda.synchronize()
        rel = max_err(got.cpu(), want) / float(want.abs().max())
        check(got.shape == want.shape and bool(torch.isfinite(got).all())
              and rel <= LEGACY_TOL,
              f"legacy head {name}: out {tuple(got.shape)}, card vs CPU "
              f"max|err| / max|out| {rel:.2e} (<= {LEGACY_TOL}); "
              f"{start.elapsed_time(end) / 5:.3f} ms on {CARD[0]}")


class LaunchProbe:
    """Wraps ``make_infer_step`` where ``module`` calls it and records, for
    each step call, its lanes and the sweep and prediction kernels'
    launches inside it (the counters are host-side: no sync)."""

    def __init__(self, module):
        self.module, self.make = module, module.make_infer_step
        self.calls: list[tuple[int, int, int]] = []

    def __enter__(self):
        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def counted(model, batch, bv_predict, bv_valid, *rest):
                b1, b2 = ksweep.launches, kresample.launches
                out = step(model, batch, bv_predict, bv_valid, *rest)
                self.calls.append((len(bv_valid), ksweep.launches - b1,
                                   kresample.launches - b2))
                return out
            return counted

        self.module.make_infer_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_infer_step = self.make


def write_lanes(root: str, lengths, first_idx: int = 0,
                invalid=None) -> list:
    """``write_plane_scene``s of ``lengths`` frames under one root (scene
    indices from ``first_idx``), frame ``invalid[1]`` of lane
    ``invalid[0]`` given a non-finite pose; their trajectories."""
    for k, n in enumerate(lengths):
        write_plane_scene(root, first_idx + k, n_frames=n)
    if invalid is not None:
        lane, frame = invalid
        with open(os.path.join(root, f"scene{first_idx + lane:04d}_00",
                               f"frame-{5 * frame:06d}.pose.txt"), "w") as f:
            f.write(" ".join(["nan"] * 16) + "\n")
    return [make_trajectory(k, 5, root, img_size_wh=IMG_HW[::-1],
                            d_candi=CFG.d_candi) for k in range(len(lengths))]


def windows_ok(traj) -> list[bool]:
    """Whether each window of ``traj`` (refs t_win_r .. len - t_win_r - 2)
    has all its poses finite."""
    r = CFG.t_win_r
    ok = [bool(np.isfinite(traj.pose_loader(i)).all())
          for i in range(len(traj))]
    return [all(ok[ref - r:ref + r + 1])
            for ref in range(r, len(traj) - r - 1)]


def valid_windows(traj) -> int:
    """The windows of ``traj`` whose poses are all finite: its exports."""
    return sum(windows_ok(traj))


def carried_windows(traj) -> int:
    """The valid windows of ``traj`` whose previous window was valid too:
    those with a valid carry, which run the K-Net (the loop resets the
    carry at the start and on an invalid pose)."""
    ok = windows_ok(traj)
    return sum(a and b for a, b in zip(ok, ok[1:]))


def info_rows(res_dir: str) -> list[list[str]]:
    with open(os.path.join(res_dir, "scene_path_info.txt")) as f:
        return [ln.split("  ") for ln in f.read().splitlines()]


def same_files(a: str, b: str, names) -> bool:
    return all(open(os.path.join(a, n), "rb").read()
               == open(os.path.join(b, n), "rb").read() for n in names)


def phase_lockstep(model, device, loop_info: dict, tmp: str) -> dict:
    n = len(LOCK_FRAMES)
    print(f"phase 23: {n} trajectories in lockstep on one card "
          f"(run_trajectories_parallel), write_plane_scenes of "
          f"{LOCK_FRAMES} frames at {IMG_HW[1]}x{IMG_HW[0]}, lane "
          f"{LOCK_INVALID[0]}'s frame {LOCK_INVALID[1]} with a non-finite "
          f"pose", flush=True)
    root = os.path.join(tmp, "lockstep")
    trajs = write_lanes(root, LOCK_FRAMES, invalid=LOCK_INVALID)
    dirs = [os.path.join(tmp, "lock", f"lane{i}") for i in range(n)]
    reset_launches()
    with LaunchProbe(loop_mod) as probe:
        counts = loop_mod.run_trajectories_parallel(model, CFG, trajs, dirs,
                                                    verbose=False)
    launches = read_launches()
    loop_info["lockstep"] = trajs, dirs     # phase 27's graphed run
    want = [valid_windows(t) for t in trajs]
    frames = max(LOCK_FRAMES) - 2 * CFG.t_win_r - 1
    check(counts == want, f"per-lane exported frames {counts} (the valid "
          f"windows: {want})")
    lanes = [c[0] for c in probe.calls]
    check(len(probe.calls) == frames and all(
        b1 == k and b2 == 1 for k, b1, b2 in probe.calls),
          f"one step call per lockstep frame ({len(probe.calls)} for "
          f"{frames}), each with N sweep launches for its N active lanes "
          f"and 1 prediction launch: lanes per frame {lanes}")
    carried = [carried_windows(t) for t in trajs]
    check(launches == expected_launches(sum(counts), frames,
                                        knet=sum(carried)),
          f"launches in the lockstep run: {launches} (the K-Net on "
          f"{carried} lane-frames with a valid carry)")

    # each lane alone through run_trajectory: the same frames, bit for bit
    for i, traj in enumerate(trajs):
        solo = os.path.join(tmp, "lock_solo", f"lane{i}")
        got = loop_mod.run_trajectory(model, CFG, traj, solo, verbose=False)
        a, b = info_rows(dirs[i]), info_rows(solo)
        names = [(f"{k}_{int(ra[0]):05d}.{e}", f"{k}_{int(rb[0]):05d}.{e}")
                 for ra, rb in zip(a[1:], b[1:])
                 for k, e in (("d", "pgm"), ("conf", "pgm"), ("img", "png"))]
        equal = len(a) == len(b) and all(
            open(os.path.join(dirs[i], x), "rb").read()
            == open(os.path.join(solo, y), "rb").read() for x, y in names)
        check(got == counts[i] and a[0] == list(b[0][0])
              and [r[1] for r in a[1:]] == [r[1] for r in b[1:]] and equal,
              f"lane {i}: {counts[i]} frames, its maps and images equal bit "
              f"for bit to run_trajectory's alone ({got} frames), "
              f"scene_path_info.txt JAX's lockstep header (the name's "
              f"characters two spaces apart) and the same frames (numbered "
              f"0..{counts[i] - 1} in lockstep, "
              f"{[int(r[0]) for r in b[1:]][-1] if len(b) > 1 else '-'} "
              f"last alone: JAX's row_counts and frame_cnt)")

    # run to run, and the main thread's host syncs per lockstep frame
    again = [os.path.join(tmp, "lock_again", f"lane{i}") for i in range(n)]
    sites = sync_sites(lambda: loop_mod.run_trajectories_parallel(
        model, CFG, trajs, again, verbose=False))
    check(all(same_files(a, b, os.listdir(a)) for a, b in zip(dirs, again)),
          "a second lockstep run writes the same files, bit for bit")
    n_sync = sum(sites.values())
    check(n_sync == 0, f"the main thread's host syncs in one lockstep run of "
          f"{frames} frames: {n_sync} ({n_sync / frames:.2f} per frame) "
          f"{list(sites)[:3]}")

    # the CLI with --multi_device on lanes 0 and 1, from phase 14's .tar
    reset_launches()
    _, out = quiet(cli_test_kvnet.main, loop_args(
        root, loop_info["ckpt"], os.path.join(tmp, "lock_cli"))
        + ["--multi_device", "--traj_idx", "0", "1"])
    cli_launches = read_launches()
    printed = [ln for ln in out.splitlines() if ln.startswith("trajectory")]
    # mesh=None takes JAX's rule over the cards this process sees: one here
    chose = [ln for ln in out.splitlines() if ln.startswith("lockstep mesh")]
    print(f"  the CLI's mesh=None: {chose}; lane_mesh({n}, {device}): "
          f"{lane_mesh(n, device)}", flush=True)
    check(chose == [f"lockstep mesh: 1 device(s) {device}, 2 lane(s) each"]
          and lane_mesh(n, device) == [device],
          f"mesh=None on this one card: 1 device (JAX's rule over "
          f"{torch.cuda.device_count()} visible card(s))")
    cli_dirs = [os.path.join(tmp, "lock_cli", f"loop_{i}") for i in range(2)]
    check(printed == [f"trajectory {i}: exported {counts[i]} frames"
                      for i in range(2)]
          and all(same_files(c, d, os.listdir(d))
                  for c, d in zip(cli_dirs, dirs[:2]))
          and cli_launches["resample"] == frames
          and cli_launches["sweep_fused"] == sum(counts[:2])
          and cli_launches["conv2d_bn"] == FE_LAUNCHES * sum(counts[:2])
          and cli_launches["conv3d_f32"]
          == KNET_F32_LAUNCHES * sum(carried[:2]),
          f"cli.test_kvnet --multi_device --traj_idx 0 1: {printed}, each "
          f"lane's files those of run_trajectories_parallel, launches "
          f"{cli_launches}")
    for k in launches:
        launches[k] += cli_launches[k]

    # ms per lockstep frame at N lanes against N single runs, in turns
    troot = os.path.join(tmp, "lockstep_time")
    ttrajs = write_lanes(troot, (TIME_FRAMES,) * max(TIME_LANES))
    times = {N: {"lockstep": [], "singles": []} for N in TIME_LANES}
    for turn in range(2):
        for N in TIME_LANES:
            with StepProbe(loop_mod) as p:
                loop_mod.run_trajectories_parallel(
                    model, CFG, ttrajs[:N],
                    [os.path.join(tmp, "lt", f"{turn}_{N}_{i}")
                     for i in range(N)], verbose=False)
            times[N]["lockstep"].append(statistics.median(p.frame_ms()[1:]))
            single = 0.0
            for i, traj in enumerate(ttrajs[:N]):
                with StepProbe(loop_mod) as p:
                    loop_mod.run_trajectory(
                        model, CFG, traj,
                        os.path.join(tmp, "ls", f"{turn}_{N}_{i}"),
                        verbose=False)
                single += statistics.median(p.frame_ms()[1:])
            times[N]["singles"].append(single)
    for N, t in times.items():
        lock, single = t["lockstep"], t["singles"]
        print(f"  {CARD[0]}: N={N}: lockstep {statistics.median(lock):.3f} "
              f"ms per lockstep frame (turns {' / '.join(f'{x:.3f}' for x in lock)}"
              f"), {N} single run(s) {statistics.median(single):.3f} ms per "
              f"frame of all {N} (turns "
              f"{' / '.join(f'{x:.3f}' for x in single)}); "
              f"{statistics.median(lock) / N:.3f} ms per lane-frame in "
              f"lockstep (CUDA events after each step, median of frames 2 "
              f"on)", flush=True)
    return launches


def phase_dp(device) -> dict:
    import dryrun_dp_torch

    print(f"phase 24: data-parallel training, 2 gloo ranks of one lane each, "
          f"both on {device} (dryrun_dp_torch), at {IMG_HW[1]}x{IMG_HW[0]} "
          f"D={CFG.ndepth}, fp32, Adam at lr {dryrun_dp_torch.LR}", flush=True)
    launches = {k: 0 for k in KERNELS}
    torch.cuda.empty_cache()
    try:
        res = dryrun_dp_torch.certify(2, device="cuda", config="op",
                                      timeout=400)
    except Exception as exc:
        check(False, f"the 2-rank DP step ran on the card: {exc}")
        return launches
    DP_RUNS["eager"] = res
    print(f"  {dryrun_dp_torch.describe(res)}", flush=True)
    check(res["dloss"] < 1e-4 and res["dparam"] < 3 * dryrun_dp_torch.LR
          and res["dgrad"] < dryrun_dp_torch.GRAD_RTOL
          and res["dlosses"] < dryrun_dp_torch.CARRY_RTOL,
          f"DP step vs the one-process 2-lane step: loss rel "
          f"{res['dloss']:.2e} (< 1e-4), parameters max |diff| "
          f"{res['dparam']:.2e} (< 3 lr), summed gradient rel "
          f"{res['dgrad']:.2e} (< {dryrun_dp_torch.GRAD_RTOL:.0e}), the "
          f"carry's losses rel {res['dlosses']:.2e} (< "
          f"{dryrun_dp_torch.CARRY_RTOL:.0e}); bit for bit: "
          f"{'yes' if res['bitwise'] else 'no'}")
    losses = res["losses"]
    check(res["replicas_equal"] and losses[3] < losses[1] * 1.02,
          f"both ranks end with the same parameters; the 3-step carry's "
          f"loss falls: {' -> '.join(f'{x:.4f}' for x in losses)}")
    check(res["resample_launches"] == [4, 4],
          f"each rank's 4 steps launch the prediction kernel once each: "
          f"{res['resample_launches']}")
    for r, (ms, peak) in enumerate(zip(res["ms"], res["peak_gib"])):
        print(f"  {CARD[0]}: rank {r}: ms per carry step "
              f"{' / '.join(f'{x:.1f}' for x in ms)} (host clock ending in "
              f"a sync; both ranks share the card), peak memory "
              f"{peak:.2f} GiB", flush=True)
    print(f"  {CARD[0]}: the one-process 2-lane step: ms per carry step "
          f"{' / '.join(f'{x:.1f}' for x in res['ref_ms'])}, peak memory "
          f"{res['ref_peak_gib']:.2f} GiB", flush=True)
    launches["resample"] = sum(res["resample_launches"])
    return launches


def states_equal(a, b) -> bool:
    """Two ``TrainState``s equal bit for bit: each weight, Adam's
    ``exp_avg``/``exp_avg_sq``/``step`` per parameter, and the count."""
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(x, y) for x, y in zip(
                a.model.state_dict().values(), b.model.state_dict().values()))
            and all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                    for k in ("exp_avg", "exp_avg_sq", "step")))


def phase_campaign(device, tmp: str) -> dict:
    print(f"phase 25: the training campaign (tools.train_campaign --wide) at "
          f"{IMG_HW[1]}x{IMG_HW[0]}, D={CFG.ndepth}, fp32: {CAMP_SCENES} "
          f"mixed3 scenes and 3 holdouts of {CAMP_FRAMES} frames, "
          f"{CAMP_STEPS} steps, an evaluation every {CAMP_EVAL}; then the "
          f"deviation gate (tools.eval_deviations) on its best checkpoint",
          flush=True)
    save_dir = os.path.join(tmp, "campaign")
    args = train_campaign.build_parser().parse_args([
        "--wide", "--scenes", str(CAMP_SCENES), "--max_steps",
        str(CAMP_STEPS), "--eval_every", str(CAMP_EVAL), "--save_dir",
        save_dir, "--device", str(device)])
    snapshots, losses = {}, []
    steps = make_train_step(CFG, train_campaign.settings(args)[1])

    def train_step(*a):
        out = steps(*a)
        losses.append(out.loss)
        return out

    def on_save(path, state):
        snap = snapshots[path] = copy.deepcopy(state)   # the state it saved
        for p in snap.model.parameters():    # deepcopy drops the gradients,
            p.grad = torch.zeros_like(p)     # which the train step keeps

    reset_launches()
    t0 = time.perf_counter()
    camp, summary = train_campaign.run(
        args, train_step=train_step, on_save=on_save, cfg=CFG,
        img_wh=IMG_HW[::-1], n_frames=CAMP_FRAMES,
        root=os.path.join(tmp, "scenes"))
    wall = time.perf_counter() - t0
    launches = read_launches()
    state, evals, holdouts = camp.state, camp.evals, camp.holdouts
    tcfg, make = camp.tcfg, camp.make_traj
    vals = torch.stack(losses).cpu()
    n_frames = sum(len(t) - 2 * CFG.t_win_r - 1 for t in holdouts)
    check(len(vals) == CAMP_STEPS and bool(torch.isfinite(vals).all())
          and all(math.isfinite(r["abs_rel"]) and math.isfinite(r["delta1"])
                  for _, r in evals),
          f"{len(vals)} steps, the loss finite ({float(vals[0]):.3f} -> "
          f"{float(vals[-1]):.3f}); the evaluations at steps "
          f"{[s for s, _ in evals]} finite: abs_rel "
          f"{[round(r['abs_rel'], 4) for _, r in evals]}, delta1 "
          f"{[round(r['delta1'], 4) for _, r in evals]}")
    check(launches == expected_launches(
        len(evals) * n_frames, CAMP_STEPS + len(evals) * n_frames,
        knet=len(evals) * (n_frames - len(holdouts))),
          f"launches {launches}: one sweep and one resample per holdout "
          f"frame ({len(evals)} evaluations of {n_frames} frames), one "
          f"resample per train step (the carry)")
    print(f"  {CARD[0]}: {summary['ms_per_step']} ms per step (host clock, "
          f"evaluations excluded), the whole run {wall:.1f} s: train "
          f"{summary['train_s']} s, evaluations {summary['eval_s']} s",
          flush=True)

    best = os.path.join(save_dir, "best", f"ckpt_{CAMP_EVAL:08d}")
    last = os.path.join(save_dir, f"ckpt_{CAMP_STEPS:08d}")
    check(best in snapshots and snapshots.keys() == set(camp.best_paths)
          and os.path.isdir(last) and all(
              os.path.dirname(p) == os.path.dirname(best) for p in snapshots),
          f"the campaign saved its best checkpoints under best/ (the first "
          f"at step {CAMP_EVAL}: {sorted(snapshots)}) and the step-"
          f"{CAMP_STEPS} last one")
    restored = {}
    # each best against a copy of the state it saved; the last (saved at
    # the loop's end) against the final state in memory
    for path, saved in (*sorted(snapshots.items()), (last, state)):
        fresh = create_train_state(CFG, tcfg, model=KVNet(
            CFG, device=device, seed=SEED + 7))
        restored[path], extra = restore_checkpoint(path, fresh)
        check(states_equal(restored[path], saved) and extra == {},
              f"{os.path.relpath(path, save_dir)} restored into a fresh "
              f"TrainState equals the state it saved, bit for bit (weights, "
              f"exp_avg, exp_avg_sq, step; count {restored[path].step})")
    # the same batch and the same pose-noise draw from each
    b, _, _ = window_batch(make(0), 2, CFG.t_win_r, with_labels=True)
    D, (w, h) = CFG.ndepth, make(0).dpv_size_wh
    reset_launches()
    outs = [steps(s, upload_batch(b, device),
                  torch.full((1, D, h, w), -math.log(D), device=device),
                  [False], torch.Generator(device=device).manual_seed(SEED))
            for s in (snapshots[best], restored[best])]
    check(torch.equal(outs[0].loss, outs[1].loss)
          and torch.equal(outs[0].bv_predict, outs[1].bv_predict)
          and states_equal(snapshots[best], restored[best]),
          f"one train step from the step-{CAMP_EVAL} state in memory and "
          f"from its restored checkpoint: the same loss "
          f"({float(outs[0].loss):.6f}), carry and state, bit for bit")
    stepped = read_launches()
    launches = {k: launches[k] + stepped[k] for k in KERNELS}

    model = eval_deviations.load_weights(best, CFG, device)
    reset_launches()
    rows, _ = eval_deviations.gate(model, holdouts)
    gate_launches = read_launches()
    by_arm = {r["arm"]: r for r in rows}
    at_best = dict(evals)[CAMP_EVAL]
    keys = ("abs_rel", "delta1", "depth_absdiff_mean_m",
            "depth_absdiff_p99_m", "depth_absdiff_max_m")
    check(all(math.isfinite(r[k]) for r in rows for k in keys),
          "every arm of the gate finite: " + "; ".join(
              f"{r['arm']} {r['abs_rel']} / {r['delta1']} "
              f"({r['depth_absdiff_mean_m']} m mean)" for r in rows))
    check(by_arm["exact"]["abs_rel"] == round(at_best["abs_rel"], 5)
          and by_arm["exact"]["delta1"] == round(at_best["delta1"], 5)
          and by_arm["exact"]["depth_absdiff_max_m"] == 0.0,
          f"the gate's exact arm equals the campaign's evaluation at step "
          f"{CAMP_EVAL}: abs_rel {by_arm['exact']['abs_rel']} vs "
          f"{at_best['abs_rel']:.6f}, delta1 {by_arm['exact']['delta1']} vs "
          f"{at_best['delta1']:.6f}")
    n_arms = len(eval_deviations.ARMS)
    # the extractor on the kernel path: once a frame in the exact and
    # coarse arms, once a holdout frame (2 t_win_r more than its windows)
    # in the cached and deploy arms, never in the bf16 arm (its modules)
    cached = n_frames + 2 * CFG.t_win_r * len(holdouts)
    # the exact K-Net on every frame but a holdout's first, in every arm
    # but bf16's (its modules)
    knet = sum(arm != "bf16" for arm in eval_deviations.ARMS) * (
        n_frames - len(holdouts))
    want = expected_launches(n_arms * n_frames, n_arms * n_frames,
                             extractor=2 * n_frames + 2 * cached, knet=knet)
    check(gate_launches == want,
          f"the gate's launches {gate_launches} (expected {want}): one "
          f"sweep and one resample per frame of each of its {n_arms} arms")
    return {k: launches[k] + gate_launches[k] for k in KERNELS}


def phase_mesh(device, errs) -> dict:
    import dryrun_dp_torch

    mcfg, (W, H) = train_campaign.MESH_CFG, train_campaign.MESH_WH
    h, w = H // 4, W // 4
    print(f"phase 26: the campaign's --mesh arm at JAX's reduced point "
          f"(D={mcfg.ndepth}, feature_dim {mcfg.feature_dim}, {W}x{H}, "
          f"{train_campaign.MESH_LANES} lanes a step): the sweep and the "
          f"prediction kernels against their twins at D={mcfg.ndepth}, "
          f"C={mcfg.feature_dim + 3} on the {w}x{h} grid, then 2 gloo ranks "
          f"on {device} against one process, {MESH_STEPS} steps, an "
          f"evaluation every {MESH_EVAL}", flush=True)
    for pose_name, poses in (("translation", translation_poses(device)),
                             ("roll 5 deg/view", _roll_poses(4, 5.0, device))):
        ref, srcs, coords = sweep_inputs(device, poses, mcfg, h, w)
        pcost, pkept = ksweep.sweep_plain(ref, srcs, coords,
                                          mcfg.sigma_soft_max, "L2", 3)
        cost, kept = ksweep.sweep_kernel(planar(ref), planar(srcs), coords,
                                         mcfg.sigma_soft_max, "L2", 3)
        torch.cuda.synchronize()
        e_cost, e_kept = max_err(cost, pcost), max_err(kept, pkept)
        errs["sweep_fused"].append(max(e_cost, e_kept))
        check(cost.shape == (mcfg.ndepth, h, w)
              and within(cost, pcost, *TOL["cost"])
              and within(kept, pkept, *TOL["kept"]),
              f"sweep at D={mcfg.ndepth} C={mcfg.feature_dim + 3} {w}x{h}, "
              f"{pose_name}, planar: max|cost err| {e_cost:.3e}, max|kept "
              f"err| {e_kept:.3e}")
    pad = math.log(1.0 / mcfg.ndepth)
    for kinds in ((k,) for k in POSES):
        args = resample_inputs(device, mcfg.ndepth, h, w, kinds, cfg=mcfg)
        got = kresample.predict_next_cuda(*args, pad)
        want = kresample.predict_next_plain(*args, pad)
        torch.cuda.synchronize()
        e = max_err(got, want)
        errs["resample"].append(e)
        check(within(got, want, *TOL["resample"]),
              f"predict_next ({mcfg.ndepth}, {h}, {w}) N=1, {kinds[0]}: "
              f"max|err| {e:.3e}")
    args = resample_inputs(device, mcfg.ndepth, h, w, POSES, cfg=mcfg)
    got = kresample.predict_next_cuda(*args, pad)
    want = kresample.predict_next_plain(*args, pad)
    torch.cuda.synchronize()
    e = max_err(got, want)
    errs["resample"].append(e)
    check(within(got, want, *TOL["resample"]),
          f"predict_next ({mcfg.ndepth}, {h}, {w}) N={len(POSES)} (a rank's "
          f"block of the carry): max|err| {e:.3e}")

    launches = {k: 0 for k in KERNELS}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as work:
            res = dryrun_dp_torch.certify_campaign(
                2, work, device=str(device), config="mesh", steps=MESH_STEPS,
                eval_every=MESH_EVAL, backend="gloo", timeout=300)
    except Exception as exc:
        check(False, f"the 2-rank --mesh campaign ran on the card: {exc}")
        return launches
    print(f"  {dryrun_dp_torch.describe_campaign(res)}", flush=True)
    check(res["dloss"] < 1e-4 and res["dgrad"] < dryrun_dp_torch.GRAD_RTOL
          and res["dlosses"] < dryrun_dp_torch.CARRY_RTOL
          and res["dparam"] < dryrun_dp_torch.PARAM_ATOL,
          f"the 2-rank --mesh campaign vs one process at 8 lanes: loss rel "
          f"{res['dloss']:.2e} (< 1e-4), summed gradient rel "
          f"{res['dgrad']:.2e} (< {dryrun_dp_torch.GRAD_RTOL:.0e}), later "
          f"losses rel {res['dlosses']:.2e} (< "
          f"{dryrun_dp_torch.CARRY_RTOL:.0e}), parameters after step 1 "
          f"max |diff| {res['dparam']:.2e} (< 0.05 lr); bit for bit: "
          f"{'yes' if res['bitwise'] else 'no'}")
    check(res["replicas_equal"] and res["only_rank0_evaluates"]
          and res["deval"] < dryrun_dp_torch.EVAL_ATOL
          and all(math.isfinite(x) for x in res["losses"]),
          f"both ranks end with the same parameters; rank 0 alone "
          f"evaluates, its abs_rel within {dryrun_dp_torch.EVAL_ATOL:.0e} "
          f"of the one process's at steps {[s for s, _ in res['evals']]} "
          f"(max |diff| {res['deval']:.2e})")
    n_frames = 2 * (train_campaign.MESH_FRAMES - 2 * mcfg.t_win_r - 1)
    n_evals = len(res["evals"])
    evaluated = {"sweep_fused": n_evals * n_frames,
                 "resample": MESH_STEPS + n_evals * n_frames}
    check(res["launches"] == [evaluated, {"sweep_fused": 0,
                                          "resample": MESH_STEPS}]
          and res["ref_launches"] == evaluated,
          f"launches: rank 0 {res['launches'][0]}, rank 1 "
          f"{res['launches'][1]}, one process {res['ref_launches']}: one "
          f"resample per train step (a rank's block of the carry) and one "
          f"sweep and one resample per holdout frame ({n_evals} evaluations "
          f"of {n_frames} frames, rank 0 only)")
    for r, (ms, peak) in enumerate(zip(res["ms"], res["peak_gib"])):
        print(f"  {CARD[0]}: rank {r}: ms per step "
              f"{' / '.join(f'{x:.1f}' for x in ms)} (host clock ending in "
              f"a sync; both ranks share the card), peak memory "
              f"{peak:.2f} GiB", flush=True)
    print(f"  {CARD[0]}: one process, 8 lanes: ms per step "
          f"{' / '.join(f'{x:.1f}' for x in res['ref_ms'])}, peak memory "
          f"{res['ref_peak_gib']:.2f} GiB; the phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for r in [*res["launches"], res["ref_launches"]]:
        for name, n in r.items():
            launches[name] += n
    return launches


class CallCount:
    """Wraps ``make_infer_step`` where ``module`` calls it: ``calls`` is
    the number of step calls started so far (a ``sync_sites`` tag)."""

    def __init__(self, module):
        self.module, self.make, self.calls = module, module.make_infer_step, 0

    def __enter__(self):
        def make(*args, **kwargs):
            step = self.make(*args, **kwargs)

            def counted(*a, **k):
                self.calls += 1
                return step(*a, **k)
            return counted

        self.module.make_infer_step = make
        return self

    def __exit__(self, *exc):
        self.module.make_infer_step = self.make


def peak_gib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def phase_graph(model, device, tmp: str, loop_info=None) -> dict:
    """Phase 27. Alone (``loop_info`` None), it writes phase 14's scene
    and checkpoint and phase 23's lanes itself."""
    print(f"phase 27: the compiled programs as CUDA graphs (infer.graph."
          f"StepGraph) at {IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    t_phase = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    if loop_info is None:
        root, ckpt = scene_and_checkpoint(model, tmp)
        traj = make_trajectory(0, 5, root, img_size_wh=IMG_HW[::-1],
                               d_candi=CFG.d_candi)
        loop_info = {"root": root, "ckpt": ckpt,
                     "windows": rollout_windows(traj, device)}
    if "lockstep" not in loop_info:
        trajs = write_lanes(os.path.join(tmp, "lockstep"), LOCK_FRAMES,
                            invalid=LOCK_INVALID)
        dirs = [os.path.join(tmp, "lock", f"lane{i}")
                for i in range(len(trajs))]
        loop_mod.run_trajectories_parallel(model, CFG, trajs, dirs,
                                           verbose=False)
        loop_info["lockstep"] = trajs, dirs

    # T=8 rollouts, graphed against eager, bit for bit, on every path
    frames = frames_on(device, T)
    windows = {k: v[:T] for k, v in loop_info["windows"].items()}
    paths = [("exact", CFG, model, frames, {}),
             ("cached", CFG, model, windows, {"cache_features": True}),
             ("fast_knet", CFG, model, frames, {"fast_knet": True})]
    paths += [(name, head_cfg(name), None, frames, {}) for name in HEADS]
    for name, cfg, m, fr, kw in paths:
        m = m or KVNet(cfg, device=device, seed=SEED, single_refine=True)
        torch.cuda.reset_peak_memory_stats()
        eager = make_rollout(cfg, **kw)(m, fr, bv0_on(device), [False])
        eager_peak = peak_gib()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start = len(graph_mod.captures)
        got = make_rollout(cfg, graph=True, **kw)(m, fr, bv0_on(device),
                                                  [False])
        graph_peak = peak_gib()
        counted = read_launches()
        caps = graph_mod.captures[start:]
        want = expected_launches(
            T, T, 10 * (T - 1) if kw.get("fast_knet") else 0,
            extractor=T + 2 * CFG.t_win_r if kw.get("cache_features")
            else None,
            knet=knet_steps(T - 1, cfg, kw.get("fast_knet", False)))
        for k in KERNELS:
            launches[k] += counted[k]
        check(counted == want and all(
            torch.equal(a, b) for a, b in zip(got[:2], eager[:2])),
            f"{name}: the graphed T={T} rollout equals the eager one bit "
            f"for bit (max |depth diff| {max_err(got[0], eager[0]):.3e}); "
            f"launches through the replays {counted} (expected {want}); "
            f"{len(caps)} graphs captured in "
            f"{' / '.join(f'{c.ms:.1f}' for c in caps)} ms; peak "
            f"{graph_peak:.2f} GiB graphed vs {eager_peak:.2f} eager")
        del m, got, eager

    # the CLI at its default --chunk_t 32 (graphed) against --chunk_t 1
    root, ckpt = loop_info["root"], loop_info["ckpt"]
    outs = {}
    for name, extra in (("graphed", []), ("eager", ["--chunk_t", "1"])):
        reset_launches()
        _, out = quiet(cli_test_kvnet.main, loop_args(
            root, ckpt, os.path.join(tmp, f"cli_{name}")) + extra)
        counted = read_launches()
        outs[name] = os.path.join(tmp, f"cli_{name}", "loop_0")
        captured = [ln for ln in out.splitlines() if "graph(s)" in ln]
        check(counted == expected_launches(T_LOOP, T_LOOP,
                                           knet=T_LOOP - 1),
              f"cli.test_kvnet {' '.join(extra) or '(chunk_t 32)'}: "
              f"launches {counted} (expected {T_LOOP} sweeps and "
              f"{T_LOOP} resamples); {captured or 'no graph captured'}")
        if name == "graphed":
            for k in KERNELS:
                launches[k] += counted[k]
    diff = pgm_diff(outs["graphed"], outs["eager"])
    check(diff == 0 and same_files(outs["graphed"], outs["eager"],
                                   os.listdir(outs["eager"])),
          f"every file of the graphed CLI equals the eager CLI's "
          f"(max |diff| {diff} unit(s) over {T_LOOP} frames)")

    # host syncs per steady graphed frame: after the 2 captures
    traj = make_trajectory(0, 5, root, img_size_wh=IMG_HW[::-1],
                           d_candi=CFG.d_candi)
    with CallCount(loop_mod) as calls:
        sites = sync_sites(lambda: loop_mod.run_trajectory(
            model, CFG, traj, os.path.join(tmp, "graph_sync"),
            verbose=False), tag=lambda: calls.calls)
    steady = {k: n for k, n in sites.items() if k[0] > 2}
    check(not steady, f"0 main-thread host syncs in the {T_LOOP - 2} steady "
          f"graphed frames ({sum(steady.values())}: {list(steady)[:3]}); "
          f"around the 2 captures: {sum(sites.values())} "
          f"{sorted({k[1] for k in sites})[:3]}")

    # the lockstep loop of phase 23: graphed lanes equal eager lanes
    trajs, dirs = loop_info["lockstep"]
    eager_dirs = [d + "_eager" for d in dirs]
    start = len(graph_mod.captures)
    loop_mod.run_trajectories_parallel(model, CFG, trajs, eager_dirs,
                                       verbose=False, graph=False)
    check(len(graph_mod.captures) == start and all(
        same_files(a, b, os.listdir(b)) for a, b in zip(dirs, eager_dirs)),
          f"phase 23's graphed lockstep run: each of its {len(dirs)} lanes "
          f"equals the eager lockstep run's, bit for bit")

    # ms per frame, graphed against eager, in turns (chunk_t 32 both)
    runs = {True: [], False: []}
    for turn in range(3):
        for graph in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = len(graph_mod.captures)
            with StepProbe(loop_mod) as p:
                t0 = time.perf_counter()
                loop_mod.run_trajectory(
                    model, CFG, traj,
                    os.path.join(tmp, f"graph_t{turn}_{graph}"),
                    verbose=False, graph=graph)
                wall = time.perf_counter() - t0
            runs[graph].append({
                "period": statistics.median(p.frame_ms()[1:]),
                "host": statistics.median(p.host_ms[2:]),
                "wall": wall, "peak": peak_gib(),
                "captures": [c.ms for c in graph_mod.captures[start:]]})
    med = {g: statistics.median(r["period"] for r in v)
           for g, v in runs.items()}
    for graph, rs in runs.items():
        def turns(key: str, digits: int) -> str:
            return " / ".join(f"{r[key]:.{digits}f}" for r in rs)
        print(f"  {CARD[0]}: {'graphed' if graph else 'eager'} loop, ms per "
              f"frame (frames 2..{T_LOOP - 1}, CUDA events after each step) "
              f"{turns('period', 3)}; host ms per step call "
              f"{turns('host', 3)}; run {turns('wall', 2)} s; peak "
              f"{turns('peak', 2)} GiB; graphs "
              f"{[len(r['captures']) for r in rs]}, capture ms per key "
              f"{[[round(c, 1) for c in r['captures']] for r in rs]}",
              flush=True)
    print(f"  graphed {med[True]:.3f} vs eager {med[False]:.3f} ms per "
          f"frame ({100 * (med[True] / med[False] - 1):+.1f}%): the loop's "
          f"default at chunk_t > 1 is the "
          f"{'graphed' if med[True] < med[False] else 'EAGER'} step by "
          f"these turns", flush=True)
    print(f"  phase 27: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def train_schedule(n: int) -> list:
    """(lane_valid, bv_valid) per step of phase 28's 4 train steps: the
    carry invalid, then valid; with 2 lanes lane 1 invalid at step 3 and
    back without its carry at step 4. Keys: 2 for 1 lane, 4 for 2."""
    if n == 1:
        return [([1], [0]), ([1], [1]), ([1], [1]), ([1], [0])]
    return [([1, 1], [0, 0]), ([1, 1], [1, 1]), ([1, 0], [1, 1]),
            ([1, 1], [1, 0])]


def train_run(cfg, n: int, device, graph: bool) -> dict:
    """Phase 28's 4 steps from the seeded weights: each step's loss, carry
    and depth map; the parameters, gradients and Adam moments after them;
    the launches; the keys captured; the peak GiB."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, TRAIN_GRAPH, model=KVNet(
        cfg, device=device, seed=SEED))
    grads = [p.grad for p in state.model.parameters()]
    step = make_train_step(cfg, TRAIN_GRAPH, graph=graph)
    gen = torch.Generator(device=device).manual_seed(SEED)
    carry = bv0_on(device).expand(n, -1, -1, -1).contiguous()
    start, outs = len(graph_mod.captures), []
    reset_launches()
    for t, (lane_valid, bv_valid) in enumerate(train_schedule(n)):
        batch = train_batch(cfg, device, n, SEED + 40 + t)
        batch["lane_valid"] = np.array(lane_valid, bool)
        out = step(state, batch, carry, bv_valid, gen)
        carry = out.bv_predict
        outs.append([out.loss.clone(), out.bv_predict.clone(),
                     out.depth_lowres.clone()])
    launches = read_launches()
    opt = state.optimizer.state
    return {"outs": outs, "launches": launches,
            "state": [(p.detach().clone(), p.grad.clone(),
                       opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone())
                      for p in state.model.parameters()],
            "grads_kept": all(p.grad is g for p, g in
                              zip(state.model.parameters(), grads)),
            "captures": graph_mod.captures[start:], "peak": peak_gib()}


def graph_train(device) -> dict:
    """Phase 28's train steps: graphed against eager bit for bit per
    configuration, then ms per step in turns."""
    launches = {k: 0 for k in KERNELS}
    for name, cfg, n in GRAPH_TRAIN_CASES:
        eager = train_run(cfg, n, device, False)
        graphed = train_run(cfg, n, device, True)
        for k in KERNELS:
            launches[k] += graphed["launches"][k]
        same = all(torch.equal(a, b) for x, y in zip(graphed["outs"],
                                                      eager["outs"])
                   for a, b in zip(x, y))
        same_state = all(torch.equal(a, b) for x, y in zip(
            graphed["state"], eager["state"]) for a, b in zip(x, y))
        want = expected_launches(0, 4)
        caps = graphed["captures"]
        keys = len({(tuple(lv), tuple(bv)) for lv, bv in train_schedule(n)})
        check(same and same_state and graphed["grads_kept"]
              and graphed["launches"] == eager["launches"] == want
              and len(caps) == keys + 1 and not eager["captures"],
              f"train step {name}: 4 graphed steps equal 4 eager ones bit "
              f"for bit (losses {[round(float(o[0]), 4) for o in eager['outs']]}"
              f"; carries, depths, parameters, gradients, Adam's moments: "
              f"{same and same_state}); the gradients kept in place "
              f"{graphed['grads_kept']}; launches through the replays "
              f"{graphed['launches']} (expected {want}); {len(caps)} graphs "
              f"captured ({keys} keys and the clip) in "
              f"{' / '.join(f'{c.ms:.1f}' for c in caps)} ms; "
              f"peak {graphed['peak']:.2f} GiB graphed vs "
              f"{eager['peak']:.2f} eager")
        del eager, graphed
    # ms per step, graphed and eager, in turns
    for name, n, turns in (("fp32, 1 lane", 1, 3), ("fp32, 2 lanes", 2, 1)):
        rows = {True: [], False: []}
        for _ in range(turns):
            for graph in (True, False):
                start = len(graph_mod.captures)
                ms, host, peak, out, rest = train_step_ms(device, None, CFG,
                                                          n, graph)
                rows[graph].append((ms, host, peak, [
                    round(c.ms, 1) for c in graph_mod.captures[start:]]))
                del out, rest
                torch.cuda.empty_cache()
        for graph, rs in rows.items():
            print(f"  {CARD[0]}: train step {name}, "
                  f"{'graphed' if graph else 'eager'}: ms per step (CUDA "
                  f"events over 5 steps) "
                  f"{' / '.join(f'{r[0]:.2f}' for r in rs)}; host ms per "
                  f"step call {' / '.join(f'{r[1]:.3f}' for r in rs)}; peak "
                  f"in the timed steps {' / '.join(f'{r[2]:.2f}' for r in rs)}"
                  f" GiB (graphed: the pool was taken at the capture); "
                  f"capture ms per key {[r[3] for r in rs]}", flush=True)
        med = {g: statistics.median(r[0] for r in rs)
               for g, rs in rows.items()}
        print(f"  train step {name}: graphed {med[True]:.2f} vs eager "
              f"{med[False]:.2f} ms per step "
              f"({100 * (med[True] / med[False] - 1):+.1f}%)", flush=True)
    return launches


def graph_dp(device) -> dict:
    """Phase 24's 2-rank DP step, graphed in both rank processes, against
    phase 24's eager run (run here when phase 28 runs alone)."""
    import dryrun_dp_torch

    launches = {k: 0 for k in KERNELS}
    torch.cuda.empty_cache()
    try:
        if "eager" not in DP_RUNS:
            DP_RUNS["eager"] = dryrun_dp_torch.certify(
                2, device="cuda", config="op", timeout=400)
        res = dryrun_dp_torch.certify(2, device="cuda", config="op",
                                      timeout=400, graph=True)
    except Exception as exc:
        check(False, f"the graphed 2-rank DP step ran on the card: {exc}")
        return launches
    eager = DP_RUNS["eager"]
    print(f"  {dryrun_dp_torch.describe(res)}", flush=True)
    check(res["losses"] == eager["losses"] and res["bitwise"] ==
          eager["bitwise"] and res["replicas_equal"]
          and res["dloss"] < 1e-4 and res["dgrad"] < dryrun_dp_torch.GRAD_RTOL
          and res["resample_launches"] == [4, 4],
          f"the 2-rank DP step graphed (2 gloo ranks on the card): its "
          f"losses equal the eager DP run's bit for bit "
          f"({' -> '.join(f'{x:.6f}' for x in res['losses'])}); against the "
          f"one-process step loss rel {res['dloss']:.2e}, summed gradient "
          f"rel {res['dgrad']:.2e}, bit for bit "
          f"{'yes' if res['bitwise'] else 'no'} (eager DP: "
          f"{'yes' if eager['bitwise'] else 'no'}); replicas equal "
          f"{res['replicas_equal']}; prediction launches per rank "
          f"{res['resample_launches']}")
    for r, (ms, peak) in enumerate(zip(res["ms"], res["peak_gib"])):
        print(f"  {CARD[0]}: graphed DP rank {r}: ms per carry step "
              f"{' / '.join(f'{x:.1f}' for x in ms)} (the first captures; "
              f"eager {' / '.join(f'{x:.1f}' for x in eager['ms'][r])}), "
              f"peak {peak:.2f} GiB", flush=True)
    launches["resample"] = sum(res["resample_launches"])
    return launches


def graph_campaign(device, tmp: str) -> dict:
    """The campaign's 4-step self-check, graphed by its default on the
    card, on phase 25's scenes (written when phase 28 runs alone)."""
    from neuralrgbd_tpu_torch.tools.train_campaign import eval_refs

    args = train_campaign.build_parser().parse_args([
        "--wide", "--scenes", "1", "--max_steps", "4", "--eval_every", "2",
        "--eval_frames", "2", "--save_dir", os.path.join(tmp, "camp_graph"),
        "--device", str(device)])
    reset_launches()
    start = len(graph_mod.captures)
    (camp, summary), _ = quiet(train_campaign.run, args, cfg=CFG,
                               img_wh=IMG_HW[::-1], n_frames=CAMP_FRAMES,
                               root=os.path.join(tmp, "scenes"))
    launches = read_launches()
    refs = [len(eval_refs(h, CFG.t_win_r, 2)) for h in camp.holdouts]
    frames = len(camp.evals) * sum(refs)
    want = expected_launches(frames, 4 + frames, knet=len(camp.evals) * sum(
        max(n - 1, 0) for n in refs))
    check(summary["graph"] is True and camp.state.step == 4
          and all(math.isfinite(m["abs_rel"]) for _, m in camp.evals)
          and launches == want,
          f"the campaign's 4-step self-check, graphed: summary graph "
          f"{summary['graph']}, steps {camp.state.step}, abs_rel "
          f"{[round(m['abs_rel'], 4) for _, m in camp.evals]}, "
          f"{summary['ms_per_step']} ms per step (host clock, captures "
          f"included); launches {launches} (expected {want}); "
          f"{len(graph_mod.captures) - start} graphs captured")
    return launches


def lba_files_equal(a: str, b: str) -> bool:
    """Every file of two LBA CLI results equal: bytes, and ``poses.npz``'s
    arrays (NaN equal to NaN)."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)):
        return False
    pa, pb = (np.load(os.path.join(d, "poses.npz")) for d in (a, b))
    poses = (np.array_equal(pa["valid"], pb["valid"])
             and np.array_equal(pa["extMs"], pb["extMs"], equal_nan=True))
    return poses and same_files(a, b, [x for x in names
                                       if x != "poses.npz"])


def lba_carried(text: str) -> int:
    """The frames of an LBA CLI run with a valid carry, which run the
    K-Net, from its printed frame lines: each exported frame right after
    an exported one (the first frame, and one after a window the pose gate
    skipped, start without a carry)."""
    seq = [ln.endswith("exported + poses optimized")
           for ln in text.splitlines() if ln.startswith("frame ")
           and ("exported" in ln or "skipped" in ln)]
    return sum(a and b for a, b in zip(seq, seq[1:]))


def graph_lba(device, loop_info: dict, tmp: str) -> dict:
    """The LBA program and the LBA CLI on both arms, graphed against
    eager (phase 21's runs; run here when phase 28 runs alone)."""
    launches = {k: 0 for k in KERNELS}
    Ks, cpu_args, _ = lba_problem()
    args = [a.to(device) for a in cpu_args]
    cams = [camera_from_K(K, device) for K in Ks]
    eager = make_lba_program(cams, max_iter=LBA_ITERS)
    graphed = make_lba_program(cams, max_iter=LBA_ITERS, graph=True)
    want = eager(*args)
    start = len(graph_mod.captures)
    got = [graphed(*args).clone() for _ in range(2)]
    caps = graph_mod.captures[start:]
    same = all(torch.equal(g.isnan(), want.isnan()) and torch.equal(
        g.nan_to_num(), want.nan_to_num()) for g in got)
    ms = {g: host_ms(lambda: (graphed if g else eager)(*args), reps=5)
          for g in (True, False)}
    n_launch = kernel_launches(lambda: graphed(*args))
    check(same and len(caps) == 1,
          f"the LBA program (V=4, {LBA_ITERS} x 3 iterations) graphed: the "
          f"capture's call and a replay equal the eager program bit for bit "
          f"{same}; {len(caps)} graph captured in {caps[0].ms:.1f} ms; "
          f"{ms[True]:.2f} ms a frame graphed vs {ms[False]:.2f} eager (host "
          f"clock to a sync); {n_launch} kernel launches from the host a "
          f"graphed frame")

    if "lba" not in loop_info:       # phase 28 alone: phase 21's eager arms
        cap = write_capture(os.path.join(tmp, "capture"))
        loop_info["lba"] = {"cap": cap}
        for arm in ("host", "device"):
            n, text = quiet(cli_lba.main, lba_args(cap, loop_info, tmp, arm)
                            + ["--no_graph"])
            loop_info["lba"][arm] = (n, os.path.join(
                tmp, f"lba_{arm}", "lba"), [x for x in text.splitlines()
                                            if x.startswith("TIMING")])
    cap = loop_info["lba"]["cap"]
    for arm in ("host", "device"):
        n_eager, eager_dir, eager_timing = loop_info["lba"][arm]
        reset_launches()
        start = len(graph_mod.captures)
        n, text = quiet(cli_lba.main, lba_args(cap, loop_info, tmp, arm,
                                               f"{arm}_graph") + ["--graph"])
        counted = read_launches()
        for k in KERNELS:
            launches[k] += counted[k]
        out_dir = os.path.join(tmp, f"lba_{arm}_graph", "lba")
        timing = [x for x in text.splitlines() if x.startswith("TIMING")]
        want = expected_launches(n, 2 * n, knet=lba_carried(text))
        check(n == n_eager and lba_files_equal(out_dir, eager_dir)
              and counted == want,
              f"cli.test_kvnet_lba --pose_graph {arm} --graph: {n} frames; "
              f"every file equal to the eager run's (poses.npz NaN equal) "
              f"{lba_files_equal(out_dir, eager_dir)}; launches through the "
              f"replays {counted} (expected {want}: B1 once, B2 and B3 once "
              f"each a frame, the K-Net on each frame with a valid carry); "
              f"{len(graph_mod.captures) - start} graphs "
              f"captured")
        print(f"  {CARD[0]}: {arm} arm graphed "
              f"{timing[0] if timing else 'no TIMING'}", flush=True)
        print(f"  {CARD[0]}: {arm} arm eager    "
              f"{eager_timing[0] if eager_timing else 'no TIMING'}",
              flush=True)
    counts = []
    for last in (CFG.t_win_r + 1 + 1, CFG.t_win_r + 1 + 1 + SYNC_FRAMES):
        sites = sync_sites(lambda: quiet(cli_lba.main, lba_args(
            cap, loop_info, tmp, "device", f"gsync{last}")
            + ["--max_frame_idx", str(last), "--graph"]))
        counts.append(sum(sites.values()))
    per_frame = (counts[1] - counts[0]) / SYNC_FRAMES
    check(per_frame == 0, f"host syncs per steady graphed device-arm frame: "
          f"{per_frame} (runs of {counts} syncs in all, {SYNC_FRAMES} "
          f"steady frames apart)")
    return launches


def phase_compiled(device, tmp: str, loop_info=None) -> dict:
    """Phase 28. Alone (``loop_info`` None), it writes phase 14's scene and
    checkpoint and phase 21's eager LBA runs itself."""
    print(f"phase 28: the compiled train and LBA programs (JAX's jitted "
          f"train step and LBA programs as CUDA graphs) at "
          f"{IMG_HW[1]}x{IMG_HW[0]}", flush=True)
    t_phase = time.perf_counter()
    if loop_info is None:
        model = KVNet(CFG, device=device, seed=SEED, single_refine=True)
        root, ckpt = scene_and_checkpoint(model, tmp)
        loop_info = {"root": root, "ckpt": ckpt}
        del model
    launches = {k: 0 for k in KERNELS}
    parts = (("train", lambda: graph_train(device)),
             ("DP", lambda: graph_dp(device)),
             ("campaign", lambda: graph_campaign(device, tmp)),
             ("LBA", lambda: graph_lba(device, loop_info, tmp)))
    for name, part in parts:
        t_part = time.perf_counter()
        try:      # a part that raises fails the phase; the next one runs
            counted = part()
        except Exception:
            check(False, f"phase 28's {name} part raised:\n"
                  f"{traceback.format_exc()}")
            continue
        for k, n in counted.items():
            launches[k] += n
        print(f"  phase 28, {name}: {time.perf_counter() - t_part:.1f} s",
              flush=True)
    print(f"  phase 28: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _f64(a: kconv2d.Act) -> torch.Tensor:
    """``a``'s value in fp64: its pending BatchNorm and ReLU applied."""
    return kconv2d.apply_pending(kconv2d.Act(
        a.raw.double(), None if a.bn is None else a.bn.double(), a.relu))


def _f64_terms(a: kconv2d.Act) -> torch.Tensor:
    """The magnitudes ``a``'s value is summed from, in fp64:
    |raw - mean| * |scale| + |beta| where a BatchNorm is pending."""
    if a.bn is None:
        return a.raw.double().abs()
    mean, scale, beta = (v.double().view(1, -1, 1, 1) for v in a.bn)
    return (a.raw.double() - mean).abs() * scale.abs() + beta.abs()


class Conv2dAudit:
    """Inside the block, each ``conv_bn`` and ``residual`` of the feature
    extractor's kernel path launches the kernels as the path does, and
    holds each launch against its plain twin run in fp64 on the same
    inputs (``CONV2D_TOL``); the chain goes on from the kernels' outputs.
    ``worst`` holds each entry's largest |error| over its allowance."""

    def __init__(self):
        self.worst = dict.fromkeys(CONV2D_TOL, 0.0)
        self.calls = {"conv": 0, "finalize": 0, "residual": 0}
        self.max_abs, self.flops, self.nbytes = 0.0, 0.0, 0.0

    def __enter__(self):
        self.saved = kconv2d.conv_bn, kconv2d.residual
        kconv2d.conv_bn, kconv2d.residual = self.conv_bn, self.residual
        return self

    def __exit__(self, *exc):
        kconv2d.conv_bn, kconv2d.residual = self.saved

    def hold(self, entry: str, got, want, allowed) -> None:
        ratio = (got - want).abs() / allowed.clamp_min(1e-30)
        self.worst[entry] = max(self.worst[entry], float(ratio.max()))

    def conv_bn(self, a, conv, bn, relu=False):
        y, part = kconv2d.conv_kernel(a, conv, bn is not None)
        self.calls["conv"] += 1
        B, N, Ho, Wo = y.shape
        M = B * Ho * Wo
        bm = kconv2d.TILES[kconv2d.config_for(M, N)][0]
        x, w = _f64(a), conv.weight.double()
        geo = dict(stride=conv.stride, padding=conv.padding,
                   dilation=conv.dilation)
        want, yd = F.conv2d(x, w, **geo), y.double()
        self.hold("conv", yd, want,
                  CONV2D_TOL["conv"] * F.conv2d(x.abs(), w.abs(), **geo))
        self.max_abs = max(self.max_abs, max_err(yd, want))
        self.flops += 2.0 * M * N * w[0].numel()
        self.nbytes += 4.0 * (a.raw.numel() + y.numel() + w.numel())
        if bn is None:
            return kconv2d.Act(y)
        tiles = kconv2d.tile_stats_plain(yd, bm)
        cnt = torch.clamp(M - bm * torch.arange(
            tiles.shape[1], device=y.device), max=bm)[:, None]
        tol = CONV2D_TOL["stats"]
        self.hold("stats", part[0, :, :N], tiles[0],
                  tol * kconv2d.tile_stats_plain(yd.abs(), bm)[0])
        self.hold("stats", part[1, :, :N], tiles[1],
                  tol * (tiles[1] + cnt * tiles[0] ** 2))
        got = kconv2d.finalize_kernel(part, M, bm, bn)
        self.calls["finalize"] += 1
        mean = yd.mean((0, 2, 3))
        var = yd.var((0, 2, 3), unbiased=False)
        tol = CONV2D_TOL["finalize"]
        self.hold("finalize", got[0], mean, tol * (mean.abs() + var.sqrt()))
        scale = bn.weight.double() / torch.sqrt(var + bn.eps)
        self.hold("finalize", got[1], scale, tol * scale.abs())
        self.hold("finalize", got[2], bn.bias.double(),
                  torch.zeros_like(scale))
        return kconv2d.Act(y, got, relu)

    def residual(self, r, skip):
        got = kconv2d.residual_kernel(r.raw, r.bn, skip)
        self.calls["residual"] += 1
        r = kconv2d.Act(r.raw, r.bn)
        self.hold("residual", got.double(), _f64(r) + _f64(skip),
                  CONV2D_TOL["residual"] * (_f64_terms(r)
                                            + _f64_terms(skip)))
        return got


@contextlib.contextmanager
def conv2d_twins():
    """The extractor's kernel path on the kernels' plain twins (fp32, on
    any device): what the row's ``plain_ms`` times."""
    names = ("conv_kernel", "finalize_kernel", "residual_kernel")
    saved = [getattr(kconv2d, n) for n in names]

    def conv(a, conv, stats, config=None):
        return kconv2d.conv_plain(a, conv, stats, kconv2d.TILES[config][0])

    for n, fn in zip(names, (conv, kconv2d.finalize_plain,
                             kconv2d.residual_plain)):
        setattr(kconv2d, n, fn)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(kconv2d, n, fn)


def phase_conv2d(model, device, frames, errs) -> dict:
    """Phase 29: the D-Net's conv kernel at the main path's shapes."""
    H, W = IMG_HW
    print(f"phase 29: the D-Net's fp32 conv kernel (conv2d_bn) against its "
          f"twins in fp64, at the feature extractor's shapes, (5, 3, {H}, "
          f"{W}) and (1, 3, {H}, {W})", flush=True)
    fe = model.feature_extractor["feature_extraction"]
    x5 = extractor_input(frames)
    row = {}
    for x in (x5, x5[-1:]):
        B = x.shape[0]
        reset_launches()
        with torch.no_grad(), step_mod.step_numerics(False):
            with Conv2dAudit() as audit:
                held = fe(x, kernels=True)
            got = fe(x, kernels=True)
            again = fe(x, kernels=True)
            cudnn = fe(x, kernels=False)
        n = read_launches()["conv2d_bn"]
        errs.append(audit.max_abs)
        calls = audit.calls
        check(sum(calls.values()) == FE_LAUNCHES and n == 3 * FE_LAUNCHES,
              f"B={B}: {calls['conv']} convs, {calls['finalize']} "
              f"finalizes and {calls['residual']} residual adds held, "
              f"{n} launches in three kernel-path calls (expected "
              f"{FE_LAUNCHES} a call)")
        check(all(v <= 1.0 for v in audit.worst.values()),
              f"B={B}: each launch within its allowance against the fp64 "
              f"twin (largest |error| / allowance per entry: "
              + ", ".join(f"{k} {v:.3g}" for k, v in audit.worst.items())
              + f"; conv max |error| {audit.max_abs:.3e})")
        check(all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(got, again, held)),
              f"B={B}: two kernel-path calls and the held one equal bit "
              f"for bit (layer1, feat)")
        print(f"  B={B}: kernel path vs cuDNN fp32, max |difference|: "
              f"layer1 {max_err(got[0], cudnn[0]):.3e}, feat "
              f"{max_err(got[1], cudnn[1]):.3e}; the convs {audit.flops:.4g} "
              f"FLOP", flush=True)
        def kern():
            return fe(x, kernels=True)

        def plain():
            with conv2d_twins():
                return fe(x, kernels=True)

        def lib():
            return fe(x, kernels=False)

        with torch.no_grad(), step_mod.step_numerics(False):
            k1, p1, l1 = call_ms(kern, 5), call_ms(plain, 3), call_ms(lib, 3)
            dev, host = device_ms(kern, calls=5, replays=3), host_us(kern, 5)
            k2, p2, l2 = call_ms(kern, 5), call_ms(plain, 3), call_ms(lib, 3)
        b_ms, by = bound(audit.nbytes, audit.flops, "fp32")
        print(f"  {CARD[0]}: the extractor at B={B} on the conv kernel: "
              f"device {dev:.3f} ms ({FE_LAUNCHES} kernel launches and the "
              f"pyramid's modules), call {k1:.3f} / {k2:.3f} ms, host "
              f"{host:.1f} us a call; its twins on the card {p1:.3f} / "
              f"{p2:.3f} ms; cuDNN fp32 (the modules, the step's numerics) "
              f"{l1:.3f} / {l2:.3f} ms; the convs' bound {b_ms:.3f} ms "
              f"({by}), {audit.flops / dev * 1e-9:.1f} TFLOP/s", flush=True)
        if B == 5:
            row = {"ms": dev, "device_ms": dev,
                   "call_ms": statistics.mean((k1, k2)), "host_us": host,
                   "plain_ms": statistics.mean((p1, p2)), "bound_ms": b_ms,
                   "bound_by": by, "library_ms": statistics.mean((l1, l2))}
        else:
            row["n1"] = {"device_ms": dev, "call_ms": statistics.mean(
                (k1, k2)), "library_ms": statistics.mean((l1, l2)),
                "bound_ms": b_ms}
    return row


def conv3d_dhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(D, H, W, C) x (N, C, 3, 3, 3) -> (D, H, W, N), padding 1, in x's
    dtype (cuDNN on the card)."""
    return F.conv3d(x.permute(3, 0, 1, 2)[None], w, padding=1)[0].permute(
        1, 2, 3, 0)


def knet_conv(cin: int, cout: int, seed: int, device) -> torch.nn.Module:
    """A seeded K-Net ``convbn_3d`` (3x3x3 conv, no bias, and its
    batch-statistics BatchNorm), the BatchNorm's scale and shift drawn
    away from 1 and 0 so that a transform at the wrong place shows."""
    layer = layers_mod.reference_init_(
        layers_mod.convbn_3d(cin, cout, 3, 1, 1), seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        layer[1].weight.copy_(0.5 + torch.rand(cout, generator=g))
        layer[1].bias.copy_(torch.rand(cout, generator=g) - 0.5)
    return layer.to(device)


def conv3d_f32_bound(P: int, C: int, N: int) -> tuple[float, str]:
    """One ``conv3d_f32`` conv over P voxels, C -> N channels: the split
    input (two parts) and the split weights read once, the output written
    once; three TF32 products a multiply-add on the tensor cores."""
    CP, NP = -(-C // 16) * 16, -(-N // 64) * 64
    nbytes = 4 * (2 * P * CP + 2 * 27 * CP * NP + P * N)
    return bound(nbytes, 3 * 2.0 * 27 * C * N * P, "tf32")


def fp64_gaps(name: str, got, cudnn, one_tf32, exact, errs: list) -> None:
    """Check ``got`` no further from ``exact`` (fp64) than KNET_F32_BAR
    times cuDNN fp32's distance, and one TF32 product further than that."""
    gaps = [float((t.double() - exact).abs().max())
            for t in (got, cudnn, one_tf32)]
    errs.append(gaps[0])
    check(gaps[0] <= KNET_F32_BAR * gaps[1] < gaps[2],
          f"{name}: max |error| against fp64 {gaps[0]:.3e}, cuDNN fp32's "
          f"{gaps[1]:.3e} (bar {KNET_F32_BAR:g}x), one TF32 product's "
          f"{gaps[2]:.3e} (must miss the bar)")


def phase_conv3d_f32(device, errs: list) -> dict:
    """Phase 30: the exact K-Net's conv kernel against its fp64 twins at
    the K-Net's layer shapes of both cells; the ``kernels`` line's row
    (the 64 -> 64 conv at ScanNet's shape, KITTI's under ``w192``)."""
    k3 = kconv3d_f32
    print(f"phase 30: the exact K-Net's conv kernel (ops.cuda.conv3d_f32) "
          f"against fp64 at (D, H, W, C) = {KNET_F32_SHAPES}", flush=True)
    rna = k3.rna_tf32
    row = {}
    for D, H, W, C in KNET_F32_SHAPES:
        where = f"({D}, {H}, {W})"
        g = torch.Generator().manual_seed(SEED + W)
        raw = torch.randn((D, H, W, C), generator=g)
        pend = torch.stack([torch.randn(C, generator=g),
                            0.5 + torch.rand(C, generator=g),
                            torch.randn(C, generator=g)])
        skip = k3.split_plain(k3.Act(torch.randn((D, H, W, C),
                                                 generator=g)))
        vol = torch.randn((16, D, H, W), generator=g)
        acts = {"a pending BatchNorm and ReLU": k3.Act(raw, pend, True),
                "a pending BatchNorm and a skip": k3.Act(raw, pend, False,
                                                         skip),
                "the K-Net's (C, D, H, W) input in place":
                    k3.Act(vol.permute(1, 2, 3, 0))}
        on = {n: k3.Act(*(t.to(device) if torch.is_tensor(t) else t
                          for t in a)) for n, a in acts.items()}
        with torch.no_grad(), step_mod.step_numerics(False):
            for n, a in acts.items():
                check(torch.equal(k3.split_kernel(on[n]).cpu(),
                                  k3.split_plain(a)),
                      f"{where} split of {n}: equal to its twin bit for bit")
            del acts, skip
            # the first layer's 16 -> C, then C -> C, whose layer, output
            # and pending BatchNorm the head and the timings below take
            ins = {16: k3.split_kernel(
                       on["the K-Net's (C, D, H, W) input in place"]),
                   C: k3.split_kernel(on["a pending BatchNorm and ReLU"])}
            for cin, s in ins.items():
                conv, bn = knet_conv(cin, C, SEED + cin, device)
                x = k3.value(s)[..., :cin]
                y, pending = k3.conv_kernel(s, conv, bn)
                y2, pending2 = k3.conv_kernel(s, conv, bn)
                exact = conv3d_dhwc(x.double(), conv.weight.double())
                fp64_gaps(f"{where} conv {cin} -> {C}", y,
                          conv3d_dhwc(x, conv.weight),
                          conv3d_dhwc(rna(x), rna(conv.weight)), exact,
                          errs)
                flat = exact.reshape(-1, C)
                mean, var = flat.mean(0), flat.var(0, unbiased=False)
                scale = bn.weight.double() / torch.sqrt(var + bn.eps)
                check(within(pending[0].double(), mean, 1e-5, 1e-5)
                      and within(pending[1].double(), scale, 1e-5, 1e-5)
                      and torch.equal(pending[2], bn.bias),
                      f"{where} conv {cin} -> {C}: the BatchNorm it leaves "
                      f"pending against the fp64 batch statistics (mean "
                      f"{max_err(pending[0].double(), mean):.2e}, scale "
                      f"{max_err(pending[1].double(), scale):.2e}; rtol and "
                      f"atol 1e-5), beta as given")
                check(torch.equal(y, y2) and torch.equal(pending, pending2),
                      f"{where} conv {cin} -> {C}: two calls equal bit for "
                      f"bit")
                del exact, flat
            head = layers_mod.reference_init_(layers_mod.Conv3d(
                C, 1, 3, 1, padding=1, bias=False), seed=SEED).to(device)
            a = k3.Act(y, pending, True)
            got = k3.head_kernel(a, head)
            v = k3.apply_pending(a)
            fp64_gaps(f"{where} head {C} -> 1", got, k3.head_plain(a, head),
                      conv3d_dhwc(rna(v), rna(head.weight))[..., 0],
                      conv3d_dhwc(v.double(), head.weight.double())[..., 0],
                      errs)
            check(torch.equal(got, k3.head_kernel(a, head)),
                  f"{where} head {C} -> 1: two calls equal bit for bit")

            # the 64 -> 64 conv (ten of the K-Net's twelve) timed beside
            # its twin and cuDNN fp32's conv (the module path's)
            s = ins[C]
            xn = k3.value(s)[..., :C].permute(3, 0, 1, 2)[None].contiguous()
            P = D * H * W
            r = time_kernel(
                f"conv3d_f32 {C} -> {C} at {where}",
                lambda: k3.conv_kernel(s, conv, bn),
                lambda: k3.conv_plain(s, conv, bn),
                conv3d_f32_bound(P, C, C),
                lambda: F.conv3d(xn, conv.weight, padding=1))
            split = on["a pending BatchNorm and a skip"]
            r.update(
                ffma_bound_ms=2.0 * 27 * C * C * P / PEAK_FLOPS["fp32"] * 1e3,
                split_ms=device_ms(lambda: k3.split_kernel(split), calls=20,
                                   replays=3),
                head_ms=device_ms(lambda: k3.head_kernel(a, head), calls=20,
                                  replays=3))
        print(f"  {CARD[0]}: {where}: the conv {r['device_ms']:.4f} ms "
              f"({2.0 * 27 * C * C * P / r['device_ms'] * 1e-9:.1f} TFLOP/s "
              f"of fp32 FLOPs; its bounds {r['bound_ms']:.4f} ms at 3xTF32, "
              f"{r['ffma_bound_ms']:.4f} ms at the fp32 FFMA rate), cuDNN "
              f"fp32 {r['library_ms']:.4f} ms a call; the split with a skip "
              f"{r['split_ms']:.4f} ms, the head {r['head_ms']:.4f} ms",
              flush=True)
        if (D, H, W, C) == KNET_LAYER:
            row = r
        else:
            row["w192"] = {k: r[k] for k in ("device_ms", "call_ms",
                                             "library_ms", "bound_ms",
                                             "split_ms", "head_ms")}
        del ins, on, s, xn, y, y2, a, v
        torch.cuda.empty_cache()
    return row


def main() -> int:
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    errs = {name: [] for name in KERNELS}
    phase_sweep(device, errs["sweep_fused"])
    phase_resample(device, errs["resample"])
    model = KVNet(CFG, device=device, seed=SEED, single_refine=True)
    launches, frames, depth, conf = phase_rollout(model, device)
    phase_plain(model, device, frames, depth, conf)
    timing = phase_timing(model, device)
    profile_step(model, device)
    phase_conv(device, errs["conv3d"])
    phase_sweep_l2(device)
    launches["conv3d"] = phase_fast(model, frames, depth)["conv3d"]
    fast_timing = phase_fast_timing(model, device)
    timing["kernels"]["conv3d"] = fast_timing["conv3d"]
    phase_syncs(model, device)
    phase_tf32(model, device)
    with tempfile.TemporaryDirectory() as tmp:
        loop_info = phase_loop(model, device, tmp)
        phase_evaluate(loop_info, tmp)
        phase_cached(model, device, loop_info, tmp)
        launches["conv3d"] += phase_coarse(model, device, frames, depth,
                                           loop_info, tmp)
        phase_bf16(model, device, frames, depth, loop_info)
        for path in (phase_train(device, loop_info, tmp),
                     phase_kitti(device, tmp, errs),
                     phase_lba(device, loop_info, tmp, errs),
                     phase_heads(model, device, loop_info, tmp),
                     phase_lockstep(model, device, loop_info, tmp),
                     phase_dp(device),
                     phase_campaign(device, tmp),
                     phase_mesh(device, errs),
                     phase_graph(model, device, tmp, loop_info),
                     phase_compiled(device, tmp, loop_info)):
            for name, n in path.items():
                launches[name] += n
    timing["kernels"]["conv2d_bn"] = phase_conv2d(model, device, frames,
                                                  errs["conv2d_bn"])
    timing["kernels"]["conv3d_f32"] = phase_conv3d_f32(device,
                                                       errs["conv3d_f32"])
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of command "
          f"time from phase 1 on", flush=True)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", *failures,
              sep="\n  ", file=sys.stderr)
        return 1
    print(json.dumps({
        "kernels": [{
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches[name],
            "max_abs_err": max(errs[name]), **timing["kernels"][name],
        } for name, mod in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--c2-cublas-child"]:
        sys.exit(c2_cublas_child())
    sys.exit(main())

"""neuralrgbd_tpu_torch — the PyTorch/CUDA port of ``neuralrgbd_tpu``.

Neural RGB->D Sensing (per-frame depth and confidence from video) on an
NVIDIA Hopper GPU. The JAX package ``neuralrgbd_tpu`` is the reference;
every module here mirrors the JAX module of the same path and is held
against it by ``tests/test_torch_*.py``.

Layer map:

- ``config``      ``ModelConfig`` and ``TrainConfig`` (the port's own copies
                  of the JAX package's).
- ``data``        the data layer (ScanNet, 7-Scenes, KITTI, the training
                  batch scheduler and augmentation: copies of the JAX
                  package's) and seeded synthetic windows and scenes.
- ``ops``         camera, grid sampling, plane sweep, DPV algebra (plain torch).
- ``ops.cuda``    hand-written CUDA C++ kernels for sm_90a (sources in
                  ``csrc/``: the plane sweep, the DPV prediction step and
                  the 3x3x3 conv, and the tracer's device stamp), each
                  beside its plain PyTorch twin, and the fast K-Net chain
                  on the conv kernel.
- ``models``      D-Net feature extractor, K-Net, R-Net, KVNet as ``nn.Module``s,
                  with every head of the JAX KVNet (DPV, ``refine_dup``,
                  DGF's guided filter, ``refine_costv``, ``dnet_bayes``)
                  and the four legacy refine heads.
- ``infer``       the per-frame inference step, the video rollout, the
                  production loop with its export (one trajectory, or N
                  in lockstep) and the AVI writer.
- ``train``       the losses, the train step (its carry on the resample
                  kernel) and the epoch loop.
- ``parallel``    devices and lane blocks, model replicas, and the
                  data-parallel train step over ``torch.distributed``.
- ``cli``         the test, evaluate and train command lines, the LBA and
                  DSO ones, and the ``.sens`` batch decoder.
- ``utils``       the JAX->torch weight bridge, checkpoints, logging,
                  timers for the card, and tracing (``utils.profiler``:
                  host spans, device stamps inside the step, Chrome
                  traces, torch.profiler traces).
- ``tools``       measurement scripts run on the card (kernel variants,
                  an older kernel beside the current one, the train CLI
                  data parallel against one process).

The port imports nothing of JAX or of the JAX package. Its entry points
build on the CUDA card unless the caller names another device.

Public functions keep the JAX package's layouts: frames (H, W, 3), features
(h, w, C), DPVs (D, h, w), poses (4, 4).
"""

__version__ = "0.1.0"

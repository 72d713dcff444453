"""Device time stamps on a hand-written CUDA kernel (``csrc/stamp.cu``).

A ``Ring`` is a buffer of ``(tag, ns)`` slots on one device and a counter
kept beside it on the same device. ``stamp(ring, tag)`` appends the
device's time at the point of the stream where it is issued: on a CUDA
device the kernel reads ``%globaltimer`` (a CUDA graph captured over it
appends new slots at every replay); on the CPU the plain twin writes
``time.time_ns()``. Once the ring is full a stamp writes nothing, and the
counter goes on counting, so ``read`` reports the drops.

Replaces no TPU kernel: it is the tracer's (``utils/profiler.py``) view
inside a CUDA graph replay. It is built and launched only while tracing
is on, so it is left out of ``build.KERNELS``.
"""

from __future__ import annotations

import ctypes
import time

import torch

from neuralrgbd_tpu_torch.ops.cuda import build, count_launch

NAME = "stamp"
SOURCE = "neuralrgbd_tpu_torch/csrc/stamp.cu"
REPLACES = None

launches = 0  # kernel launches (``count_launch``)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


class Ring:
    """``slots`` (capacity, 2) int64 ``(tag, ns)`` and ``count`` (1,) int64,
    the stamps issued so far, on ``device``."""

    def __init__(self, device, capacity: int):
        self.device = torch.device(device)
        self.slots = torch.zeros((capacity, 2), dtype=torch.int64,
                                 device=self.device)
        self.count = torch.zeros(1, dtype=torch.int64, device=self.device)

    def read(self) -> tuple:
        """``((n, 2) int64 array of the slots written, in the order the
        stamps ran; drops)``, in one copy to the host."""
        both = torch.cat([self.count.expand(2)[None], self.slots]).cpu()
        n = int(both[0, 0])
        kept = min(n, len(self.slots))
        return both[1:1 + kept].numpy(), n - kept


def stamp_plain(slots: torch.Tensor, count: torch.Tensor, tag: int) -> None:
    """The plain twin of the kernel, on CPU tensors: the host's clock."""
    ns = time.time_ns()
    i = int(count[0])
    count[0] = i + 1
    if i < len(slots):
        slots[i, 0], slots[i, 1] = tag, ns


def load() -> None:
    """Build and load the kernel now (before a stamp that is timed)."""
    build.kernel_function(NAME, _ARGTYPES)


def stamp(ring: Ring, tag: int) -> None:
    """Append ``(tag, the device's ns)`` to ``ring`` on the current stream
    of its device (the plain twin for a ring on the CPU)."""
    if ring.device.type == "cpu":
        stamp_plain(ring.slots, ring.count, tag)
        return
    fn = build.kernel_function(NAME, _ARGTYPES)
    dev = ring.device
    with torch.cuda.device(dev):     # the caller's current device kept
        err = fn(ring.slots.data_ptr(), ring.count.data_ptr(),
                 len(ring.slots), int(tag), dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(NAME, err)
    count_launch(__name__)


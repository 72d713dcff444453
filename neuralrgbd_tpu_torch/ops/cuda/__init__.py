"""Hand-written CUDA kernels for Hopper (counterpart of ``neuralrgbd_tpu/ops/pallas``).

Each kernel module holds the kernel's launcher, its plain PyTorch twin with
the same signature, a wrapper that picks between them by the tensors'
device (the twin only for CPU tensors; on a CUDA tensor it launches the
kernel or raises), and an integer ``launches`` counter. Sources live in
``neuralrgbd_tpu_torch/csrc/`` and are built by ``build``.

A wrapper counts each launch through ``count_launch``. Under a CUDA
graph's capture (``recording``) the kernel does not run: the launch goes
into the graph, and into the graph's tally instead of the counter. Each
replay of the graph adds its tally (``replayed``), so ``launches`` counts
the launches that ran, eager or replayed, on every path.

Each C entry makes its tensors' card the calling thread's current device
(``cudaSetDevice``) and does not set it back; each wrapper calls it inside
``torch.cuda.device(dev)``, which gives the caller's device back as
PyTorch does (lazily: it creates no context on a card the process has not
used), so a launch on another card moves nothing that reads "the current
device" (the lockstep loop's replicas, one per card).
"""

from __future__ import annotations

import contextlib
import sys
import threading
from collections import Counter

_capturing = threading.local()   # this thread's tallies under capture


def count_launch(module: str) -> None:
    """One launch of the kernel of ``module`` (a module name): added to its
    ``launches``, or, while this thread captures a graph, to the graph's
    tally."""
    tallies = getattr(_capturing, "tallies", None)
    if tallies:
        tallies[-1][module] += 1
    else:
        sys.modules[module].launches += 1


@contextlib.contextmanager
def recording():
    """Record the launches this thread makes inside the block: yields the
    tally ({module: launches}) that ``replayed`` adds per replay."""
    tally: Counter = Counter()
    tallies = _capturing.__dict__.setdefault("tallies", [])
    tallies.append(tally)
    try:
        yield tally
    finally:
        tallies.pop()


def replayed(tally: Counter) -> None:
    """One replay of a graph whose capture recorded ``tally``."""
    for module, n in tally.items():
        sys.modules[module].launches += n

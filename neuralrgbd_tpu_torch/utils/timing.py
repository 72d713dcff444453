"""Timers for work on the card (CUDA only: each one fails without a card).

Four views of one call, which differ most for small kernels:

- ``call_ms``: CUDA events around ``reps`` calls made back to back from
  Python. When the host takes longer to issue a call than the card takes
  to run it, this is the host's time per call, not the kernel's.
- ``device_ms``: the calls captured once in a CUDA graph and the graph
  replayed between events: the card's own time per call (kernel bodies and
  the gaps between graph nodes), with no Python in it. The kernels'
  ``launches`` count the replays (``ops.cuda.recording``).
- ``host_us``: the host clock around the same calls with no sync inside:
  what issuing one call costs the host.
- ``host_ms``: the host clock around one call that ends in a sync, as a
  caller waiting for its result sees it.
"""

from __future__ import annotations

import statistics
import time

import torch

from neuralrgbd_tpu_torch.ops.cuda import recording, replayed


def call_ms(fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 100, replays: int = 5) -> float:
    """Median over ``replays`` of the ms per call of a CUDA graph of
    ``calls`` calls of ``fn``. ``fn`` is called twice first, outside the
    graph, so that what it builds or loads once is done."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with recording() as tally, \
            torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    replayed(tally)
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        replayed(tally)
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 100) -> float:
    """Microseconds of host time per call over ``calls`` calls issued back
    to back (the card catches up after the clock stops)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def host_ms(fn, reps: int = 50) -> float:
    """Median ms of one call followed by ``torch.cuda.synchronize()``, on
    the host clock, over ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)

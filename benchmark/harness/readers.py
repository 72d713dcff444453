"""What the per-layer readers (``benchmark/metrics/<name>.py``) share: the
selections of a traced run's record (``drive._Recorder.record``) that lie
in the measured window, and the kernel times of the profiler slice that
the roofline readers divide their kernel's bound by. Steps are placed by
when the card finished them, host-side calls by when the host made them.
"""

from __future__ import annotations


def in_window(record: dict, t: float) -> bool:
    lo, hi = record["window"]
    return lo < t <= hi


def steps_done_in_window(record: dict) -> dict:
    """{device: [step, ...]} of the steps the card finished in the window,
    in the order it finished them."""
    out: dict = {}
    for s in record["steps"]:
        if in_window(record, s["done"]):
            out.setdefault(s["device"], []).append(s)
    return {d: sorted(v, key=lambda s: s["done"]) for d, v in out.items()}


def frame_period_ms(record: dict):
    """The card's time per step call over the window, mean over cards:
    (last step's end - first's) / the steps between them."""
    periods = [1e3 * (v[-1]["done"] - v[0]["done"]) / (len(v) - 1)
               for v in steps_done_in_window(record).values() if len(v) > 1]
    return sum(periods) / len(periods) if periods else None


def step_mfu_pct(record: dict):
    """The FLOPs of the steps finished after each card's first in the
    window, over that card's time, summed over the cards, as a share of
    their fp32 peak."""
    by_dev = {d: v for d, v in steps_done_in_window(record).items()
              if len(v) > 1}
    if not by_dev:
        return None
    rate = sum(sum(s["flops"] for s in v[1:]) / (v[-1]["done"] - v[0]["done"])
               for v in by_dev.values())
    return 100.0 * rate / (len(by_dev) * record["peak_flops"])


def idle_pct(record: dict):
    sl = record["slice"]
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])


def kernel_mean_ms(record: dict, pattern: str):
    """The mean device ms of the kernels whose name holds ``pattern`` in
    the profiler slice; None where the slice ran none."""
    hits = [v for name, v in record["slice"].get("kernel_s", {}).items()
            if pattern in name]
    n = sum(c for _, c in hits)
    return 1e3 * sum(s for s, _ in hits) / n if n else None


def roofline_pct(record: dict, pattern: str, flops: float, nbytes: float):
    """A kernel's least time by its bound (``counts.bound_ms`` of its
    operations and bytes a launch) over its mean time in the profiler
    slice; None where the slice ran none."""
    from benchmark.harness import counts
    mean_ms = kernel_mean_ms(record, pattern)
    if mean_ms is None:
        return None
    return 100.0 * counts.bound_ms(nbytes, flops, record["peak"])[0] / mean_ms

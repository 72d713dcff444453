"""The plane-sweep kernel (``csrc/sweep_fused.cu``, launched as
``sweep_fused_kernel``) against its roofline: its least time by its bound
(``counts.sweep`` of one lane-frame's shapes: 1.16 GFLOP fp32 and 41.3 MB
at 96x64, operations bound) over its mean device time in the profiler
slice. Layer: kernels."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct

KERNEL = "sweep_fused_kernel"


def read(record):
    m, (W, H) = record["model"], record["img_wh"]
    flops, nbytes = counts.sweep(2 * m["t_win_r"], m["ndepth"], H // 4,
                                 W // 4, m["feature_dim"] + 3)
    return roofline_pct(record, KERNEL, flops, nbytes)

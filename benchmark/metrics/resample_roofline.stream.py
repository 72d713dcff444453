"""The prediction kernel (``csrc/resample.cu``, launched as
``predict_kernel``, once a step call for the step's lanes) against its
roofline: its least time by its bound (``counts.resample`` of the step's
lanes: 3.1 MB read and written a lane at (64, 64, 96), bytes bound) over
its mean device time in the profiler slice. Layer: kernels."""

from benchmark.harness import counts
from benchmark.harness.readers import roofline_pct

KERNEL = "predict_kernel"


def read(record):
    m, (W, H) = record["model"], record["img_wh"]
    flops, nbytes = counts.resample(record["lanes_per_step"], m["ndepth"],
                                    H // 4, W // 4)
    return roofline_pct(record, KERNEL, flops, nbytes)

"""The whole step's share of the card's fp32 peak over the window: the
model's FLOPs of every lane-frame the cards finished (counted from the
shapes, ``harness/counts.frame``), over the cards' time, over the peak of
the cards used (67 TFLOP/s each). Layer: step."""

from benchmark.harness.readers import step_mfu_pct


def read(record):
    return step_mfu_pct(record)

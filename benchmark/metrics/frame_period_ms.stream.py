"""The card's frame period: per card, the time from the first step call it
finished in the window to the last, over the step calls between them
(a CUDA event after each call, placed on the wall clock by an anchor event);
the mean over the cards. Layer: step."""

from benchmark.harness.readers import frame_period_ms


def read(record):
    return frame_period_ms(record)

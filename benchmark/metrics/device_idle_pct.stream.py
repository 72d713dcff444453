"""The share of the profiler's slice in which no operation ran on the
card (kernels, copies and sets), the mean over the cards. Layer: device."""

from benchmark.harness.readers import idle_pct


def read(record):
    return idle_pct(record)

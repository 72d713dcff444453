"""The host's ms per step call (the graph's copy-in and replay), the mean
over the calls made in the window. Layer: loop."""

from benchmark.harness.readers import in_window


def read(record):
    ms = [s["host_ms"] for s in record["steps"]
          if in_window(record, s["wall"])]
    return sum(ms) / len(ms) if ms else None

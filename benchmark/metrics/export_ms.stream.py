"""The wall ms of an ``export_frame`` call on an export thread (the PNG
and the two PGMs of a frame), the mean over the calls begun in the
window. Layer: decode/export."""

from benchmark.harness.readers import in_window


def read(record):
    ms = [m for wall, m in record["exports"] if in_window(record, wall)]
    return sum(ms) / len(ms) if ms else None

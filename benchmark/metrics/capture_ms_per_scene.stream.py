"""The host ms of the step graphs captured by the calls begun in the
window (the program's ``infer.graph.captures``, each key's eager warm-up
and capture), over those calls: what each scene pays to capture its graphs
anew. Layer: graph."""

from benchmark.harness.readers import in_window


def read(record):
    calls = [c for c in record["calls"] if in_window(record, c["start"])]
    if not calls:
        return None
    return sum(sum(c["captures_ms"]) for c in calls) / len(calls)

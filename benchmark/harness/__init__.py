"""The harness: the files read by name (``spec``), the run (``drive``),
its window, probes, weights, counts and the check."""

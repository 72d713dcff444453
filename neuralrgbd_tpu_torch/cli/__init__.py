"""Command-line entry points: ``test_kvnet`` (inference with given poses,
the pgm export contract) and ``evaluate`` (depth metrics over GT)."""

"""Synthetic inputs for tests and chip runs."""

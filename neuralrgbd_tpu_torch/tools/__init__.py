"""Measurement scripts that run on the card."""

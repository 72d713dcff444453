"""The JAX-to-torch weight bridge, and timers for the card."""

"""Training: the losses, the train step and the epoch loop."""

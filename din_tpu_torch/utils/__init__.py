"""Meters and logging of the training loop."""

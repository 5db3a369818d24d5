"""Training of the port: losses, optimizer, checkpoints and the loop."""

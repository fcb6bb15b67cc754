"""Training of the port: train state and optimizer, SDE train step and epoch."""

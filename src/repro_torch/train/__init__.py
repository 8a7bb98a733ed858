"""Training of the port: the train step with its gradient syncs, the
checkpoint manager and the training loop."""

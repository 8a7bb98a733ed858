"""Training of the port: the train step with its gradient syncs, the
checkpoint manager, the training loop and the straggler deadline
executor."""

"""Train, eval and serving steps, and the training loop."""

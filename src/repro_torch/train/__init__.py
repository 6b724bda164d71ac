"""Train, prefill and decode steps, and the training loop."""

"""Training data: producers, the batch queue and the stream position."""

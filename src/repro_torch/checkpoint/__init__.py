"""Checkpoints of parameters, optimizer state and data position."""

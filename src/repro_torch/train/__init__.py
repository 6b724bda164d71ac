"""Prefill and decode steps."""

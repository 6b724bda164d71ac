"""Run-time support: fault injection."""

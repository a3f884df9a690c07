"""Resilience plane of the port (a copy of the JAX package's resilience/,
cut to the retry policy the runtime's reconnect loops use)."""

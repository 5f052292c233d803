"""Run-time observability of the port (copies of the JAX package's
obs/ modules, without JAX)."""

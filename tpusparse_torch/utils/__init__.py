"""Result comparison, carrying JAX plans to the port, and the tracer."""

"""Result comparison and carrying JAX plans across to the port."""

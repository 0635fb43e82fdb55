"""Weight carry-over from the JAX package."""

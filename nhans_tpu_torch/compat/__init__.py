"""Weight formats shared with the JAX package."""

"""Weight bridge from the JAX package, optimizer and training steps."""

"""Weight converters between the JAX package's params and the port."""

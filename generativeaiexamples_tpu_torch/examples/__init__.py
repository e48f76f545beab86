"""Examples built on the port (counterpart of the JAX repository's
examples/)."""

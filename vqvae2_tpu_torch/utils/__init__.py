"""Checkpoints and the import of JAX weights."""

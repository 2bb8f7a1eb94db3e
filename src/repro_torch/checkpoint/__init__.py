"""Atomic, asynchronous checkpoints (the port's copy of the JAX package's
``checkpoint``)."""

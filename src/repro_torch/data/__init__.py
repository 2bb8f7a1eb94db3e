"""Token streams for training (the port's copy of the JAX package's
``data``)."""

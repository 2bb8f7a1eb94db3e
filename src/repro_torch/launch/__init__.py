"""The training launcher (the port's copy of the JAX package's
``launch/train.py``)."""

"""Serving: the continuous-batching token engine (``engine``)."""

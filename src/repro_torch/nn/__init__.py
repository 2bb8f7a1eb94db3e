"""Layers of the LM path: norms, embeddings and rotary phases, FFNs and
attention, each the port's copy of the JAX package's ``nn/`` module."""

"""Model configurations: ``ModelConfig`` and the ten architectures."""

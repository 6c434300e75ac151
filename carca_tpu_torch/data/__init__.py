"""Dataset containers and the synthetic catalog generator."""

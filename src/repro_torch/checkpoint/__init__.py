"""Step-atomic checkpoints."""

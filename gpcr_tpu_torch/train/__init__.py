"""Training: losses, the trainer and its data pipeline."""

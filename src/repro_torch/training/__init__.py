"""Training substrate: the AdamW optimiser and its learning-rate schedule."""

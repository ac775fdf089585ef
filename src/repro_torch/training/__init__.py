"""Training substrate: the AdamW optimiser and its learning-rate schedule
(`optim.py`), checkpoints (`checkpoint.py`) and the training loop
(`loop.py`)."""

"""Entry points: the serving launcher (`python -m repro_torch.launch.serve`)."""

"""Runnable end-to-end examples: ``python -m repro_torch.examples.<name>``."""

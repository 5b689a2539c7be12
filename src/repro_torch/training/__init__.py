"""The training stack: optimizers, checkpoints, gradient compression and
the fault-tolerant loop (``repro/training/``)."""

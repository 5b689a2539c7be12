"""Sharding rules (``sharding``) and the per-rank program of sharded
training (``parallelize``): PyTorch port of ``repro/distributed``."""

"""PyTorch + CUDA port of the ASC cluster-skipping retrieval system.

Mirrors ``repro``'s layout module for module and never imports JAX or
``repro``. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the four Pallas kernels of the JAX package are CUDA
kernels under ``kernels/csrc/``.
"""

"""Hand-written Hopper kernels (sources in ``../csrc``), their wrappers and
their plain PyTorch versions."""

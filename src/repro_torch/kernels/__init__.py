"""Hand-written Hopper kernels of the port, their plain PyTorch versions
and the model-layout wrappers (``ops``).  Nothing is compiled at import."""

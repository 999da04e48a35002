"""Hand-written Hopper kernels, their plain PyTorch versions (``ref``) and
the device-based dispatch the models call (``ops``)."""

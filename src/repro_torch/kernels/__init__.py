"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version; ``ops`` is the entry point that picks between them by device."""

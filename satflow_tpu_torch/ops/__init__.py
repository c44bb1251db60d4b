"""Hand-written CUDA kernels for the card, each beside its plain PyTorch version."""

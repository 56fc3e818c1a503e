"""Device kernels (CUDA, with plain PyTorch twins) and cost potentials."""

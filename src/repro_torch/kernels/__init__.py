"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions;
``ops`` dispatches by the tensor's device."""

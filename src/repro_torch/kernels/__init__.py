"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported."""

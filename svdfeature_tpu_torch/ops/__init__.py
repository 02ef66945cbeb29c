"""Train-step containers, the forward path and the CUDA kernels."""

"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version and a wrapper that picks between them by the tensor's device
(``kernels.dispatch``)."""

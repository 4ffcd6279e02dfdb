# Hand-written CUDA kernels (csrc/), their loaders, plain PyTorch
# versions (ref.py) and the device-dispatching wrappers (ops.py).

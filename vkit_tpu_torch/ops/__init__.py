"""Device ops of the port: hand-written CUDA kernels (kernels.py) and the
warps and compositors built on them."""

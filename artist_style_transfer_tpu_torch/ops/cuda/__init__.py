"""Hand-written CUDA kernels for Hopper: the build (``build``) and the wrappers."""

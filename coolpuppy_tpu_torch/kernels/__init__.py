"""Hand-written CUDA kernels of the port: build and ``ctypes`` binding."""

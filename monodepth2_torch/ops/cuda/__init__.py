"""Hand-written CUDA kernels for Hopper (sm_90a) and their ctypes binding.
Nothing is built or loaded at import; see _lib.py."""

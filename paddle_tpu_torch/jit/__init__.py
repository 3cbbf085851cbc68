"""Step capture (``jit.capture``): serving steps as CUDA graphs."""

"""Step capture (``jit.capture``): serving steps and whole train steps as
CUDA graphs; ``jit.program`` the record of a captured train step,
``jit.passes`` its report and lint."""

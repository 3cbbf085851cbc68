"""Functionals, layers and gradient clipping of the LLaMA serving and
training paths."""

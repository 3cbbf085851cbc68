"""Incubating layers and functionals; see ``incubate.nn.functional``."""

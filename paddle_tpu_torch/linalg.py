"""The ``linalg`` namespace (counterpart of ``paddle_tpu/linalg.py``):
the decomposition and solve ops of ``ops.linalg``."""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, inv, lstsq, lu, lu_unpack, matrix_power, matrix_rank, multi_dot,
    norm, pca_lowrank, pinv, qr, slogdet, solve, svd, triangular_solve,
)

__all__ = [
    "cholesky", "norm", "cond", "cov", "corrcoef", "inv", "eig", "eigvals",
    "multi_dot", "matrix_rank", "svd", "qr", "pca_lowrank", "lu", "lu_unpack",
    "matrix_power", "det", "slogdet", "eigh", "eigvalsh", "pinv", "solve",
    "cholesky_solve", "triangular_solve", "lstsq",
]

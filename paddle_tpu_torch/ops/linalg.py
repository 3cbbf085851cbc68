"""Linear algebra ops (counterpart of ``paddle_tpu/ops/linalg.py``), over
``torch.linalg``, which runs them on the card (cuSOLVER) as on the CPU.
``eig``/``eigvals``, which the JAX package computes on the host with
numpy, run through ``torch.linalg`` on the tensor's device."""
from __future__ import annotations

import torch

from .dispatch import apply

__all__ = [
    "norm", "cond", "matrix_power", "det", "slogdet", "inv", "pinv", "solve",
    "triangular_solve", "cholesky", "cholesky_solve", "qr", "svd", "eig",
    "eigh", "eigvals", "eigvalsh", "lu", "lu_unpack", "matrix_rank",
    "multi_dot", "lstsq", "corrcoef", "cov", "householder_product",
    "pca_lowrank",
]


def norm(x, p="fro", axis=None, keepdim=False):
    def f(v):
        if p == "fro" and axis is None:
            return torch.sqrt(torch.sum(torch.square(v)))
        if axis is None:
            return torch.linalg.vector_norm(v.reshape(-1), 2 if p == "fro"
                                            else p)
        if isinstance(axis, (list, tuple)):
            return torch.linalg.matrix_norm(v, p, dim=tuple(axis),
                                            keepdim=keepdim)
        if p == "fro":
            return torch.sqrt(torch.sum(torch.square(v), axis, keepdim))
        if p == float("inf"):
            return torch.amax(torch.abs(v), axis, keepdim)
        if p == float("-inf"):
            return torch.amin(torch.abs(v), axis, keepdim)
        if p == 0:
            return torch.sum((v != 0).to(v.dtype), axis, keepdim)
        return torch.sum(torch.abs(v) ** p, axis, keepdim) ** (1.0 / p)
    return apply(f, x, op_name="norm")


def cond(x, p=None):
    return apply(lambda v: torch.linalg.cond(v, p), x, op_name="cond")


def matrix_power(x, n):
    return apply(lambda v: torch.linalg.matrix_power(v, int(n)), x,
                 op_name="matrix_power")


def det(x):
    return apply(torch.linalg.det, x, op_name="det")


def slogdet(x):
    def f(v):
        s, l = torch.linalg.slogdet(v)
        return torch.stack([s, l])
    return apply(f, x, op_name="slogdet")


def inv(x):
    return apply(torch.linalg.inv, x, op_name="inv")


def pinv(x, rcond=1e-15, hermitian=False):
    return apply(lambda v: torch.linalg.pinv(v, rtol=rcond,
                                             hermitian=hermitian),
                 x, op_name="pinv")


def solve(x, y):
    return apply(torch.linalg.solve, x, y, op_name="solve")


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    def f(a, b):
        aa = a.transpose(-1, -2) if transpose else a
        return torch.linalg.solve_triangular(
            aa, b, upper=upper != transpose, unitriangular=unitriangular)
    return apply(f, x, y, op_name="triangular_solve")


def cholesky(x, upper=False):
    return apply(lambda v: torch.linalg.cholesky(v, upper=upper), x,
                 op_name="cholesky")


def cholesky_solve(x, y, upper=False):
    return apply(lambda b, c: torch.cholesky_solve(
        b, torch.triu(c) if upper else torch.tril(c), upper=upper), x, y,
                 op_name="cholesky_solve")


def qr(x, mode="reduced"):
    out = apply(lambda v: tuple(torch.linalg.qr(v, mode=mode)), x,
                op_name="qr")
    return out[1] if mode == "r" else (out[0], out[1])


def svd(x, full_matrices=False):
    out = apply(lambda v: tuple(torch.linalg.svd(
        v, full_matrices=full_matrices)), x, op_name="svd")
    return out[0], out[1], out[2]


def _real_if_real(*ts):
    """numpy's rule, which the JAX op inherits: real results when every
    eigenvalue is real (a host read, as numpy's)."""
    if bool((ts[0].imag == 0).all()):
        return tuple(t.real.contiguous() for t in ts)
    return ts


def eig(x):
    out = apply(lambda v: _real_if_real(*torch.linalg.eig(v)), x,
                op_name="eig")
    return out[0], out[1]


def eigh(x, UPLO="L"):
    out = apply(lambda v: tuple(torch.linalg.eigh(v, UPLO=UPLO)), x,
                op_name="eigh")
    return out[0], out[1]


def eigvals(x):
    return apply(lambda v: _real_if_real(torch.linalg.eigvals(v))[0], x,
                 op_name="eigvals")


def eigvalsh(x, UPLO="L"):
    return apply(lambda v: torch.linalg.eigvalsh(v, UPLO=UPLO), x,
                 op_name="eigvalsh")


def lu(x, pivot=True):
    """``(LU, pivots)``: LAPACK's packed factors and 1-based int32
    pivots."""
    out = apply(lambda v: tuple(torch.linalg.lu_factor(v, pivot=pivot)), x,
                op_name="lu")
    return out[0], out[1]


def matrix_rank(x, tol=None, hermitian=False):
    return apply(lambda v: torch.linalg.matrix_rank(v, rtol=tol,
                                                    hermitian=hermitian),
                 x, op_name="matrix_rank")


def multi_dot(x, name=None):
    return apply(lambda *vs: torch.linalg.multi_dot(list(vs)), *x,
                 op_name="multi_dot")


def lstsq(x, y, rcond=None, driver=None):
    """``(solution, residuals, rank, singular_values)`` as ``jnp``'s:
    the minimum-norm solution; residuals (the squared column norms of
    ``x @ sol - y``) only when ``x`` has full column rank and more rows
    than columns, else empty."""
    def f(a, b):
        m, n = a.shape[-2], a.shape[-1]
        eps = torch.finfo(a.dtype).eps
        rc = rcond if rcond is not None else eps * max(m, n)
        sv = torch.linalg.svdvals(a)
        rank = (sv > rc * sv.amax(-1, keepdim=True)).sum(-1)
        sol = torch.linalg.pinv(a, rtol=rc) @ b
        if bool(rank == n) and m > n:
            res = torch.sum(torch.square(a @ sol - b), dim=-2)
        else:
            res = torch.zeros((0,), dtype=a.dtype, device=a.device)
        return sol, res, rank.to(torch.int64), sv
    out = apply(f, x, y, op_name="lstsq")
    return out[0], out[1], out[2], out[3]


def corrcoef(x, rowvar=True):
    return apply(lambda v: torch.corrcoef(v if rowvar else v.T), x,
                 op_name="corrcoef")


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return apply(lambda v: torch.cov(v if rowvar else v.T,
                                     correction=1 if ddof else 0),
                 x, op_name="cov")


def householder_product(x, tau):
    return apply(torch.linalg.householder_product, x, tau,
                 op_name="householder_product")


def pca_lowrank(x, q=None, center=True, niter=2):
    """The top ``q`` singular triplets of ``x`` (centred) from a full SVD:
    deterministic, as the JAX op (torch's ``pca_lowrank`` is randomised)."""
    def f(v):
        qq = q or min(6, *v.shape[-2:])
        vv = v - v.mean(dim=-2, keepdim=True) if center else v
        u, s, vt = torch.linalg.svd(vv, full_matrices=False)
        return u[..., :qq], s[..., :qq], vt.transpose(-1, -2)[..., :qq]
    out = apply(f, x, op_name="pca_lowrank")
    return out[0], out[1], out[2]


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` from ``lu``'s packed factors and 1-based pivots."""
    out = apply(lambda a, p: tuple(torch.lu_unpack(a, p.to(torch.int32))),
                x, y, op_name="lu_unpack")
    return out[0], out[1], out[2]

"""Gaussian conditionals (counterpart of ``gpflow_tpu/conditionals/util.py``).

``base_conditional_with_lm``: A = Lm^-1 Kmn; fvar = Knn - A^T A, plus the
q_sqrt term; an extra back-solve when not whitened.

The INV_SOLVE route (``set_inv_solve``/``inv_solve``) replaces the wide
[M, N] triangular solve by one [M, M] inversion and matmuls when N > M.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..base import MeanAndVariance
from ..ops.linalg import chol_and_inverse, cholesky, triangular_inverse

__all__ = [
    "base_conditional",
    "base_conditional_with_lm",
    "expand_independent_outputs",
    "inv_solve",
    "set_inv_solve",
]

_inv_solve_state: list = []  # [] = off (the default); [bool] = set explicitly


def set_inv_solve(value: Optional[bool]) -> None:
    """Turns the INV_SOLVE route on (True) or off (False); None restores the
    default, off. Read at every call of the conditionals."""
    _inv_solve_state.clear()
    if value is not None:
        _inv_solve_state.append(bool(value))


@contextlib.contextmanager
def inv_solve(value: bool = True) -> Iterator[None]:
    """Context-manager form of :func:`set_inv_solve`."""
    prev = list(_inv_solve_state)
    set_inv_solve(value)
    try:
        yield
    finally:
        _inv_solve_state.clear()
        _inv_solve_state.extend(prev)


def _use_inv_solve() -> bool:
    return bool(_inv_solve_state and _inv_solve_state[0])


def base_conditional(
    Kmn: torch.Tensor,
    Kmm: torch.Tensor,
    Knn: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Single-output GP conditional q(g1) = int q(g2) p(g1|g2) dg2.

    Kmn: [M, batch..., N], Kmm: [M, M], Knn: [batch..., N, N] or [batch..., N],
    f: [M, R], q_sqrt: [M, R] (diagonal) or [R, M, M] (lower triangular).
    Returns mean [batch..., N, R] and var [batch..., R, N, N] / [batch..., N, R].
    """
    if _use_inv_solve() and Kmn.shape[-1] > Kmm.shape[-1]:
        Lm, Lm_inv = chol_and_inverse(Kmm)
        return base_conditional_with_lm(
            Kmn=Kmn, Lm=Lm, Knn=Knn, f=f, full_cov=full_cov, q_sqrt=q_sqrt,
            white=white, Lm_inv=Lm_inv,
        )
    Lm = cholesky(Kmm)
    return base_conditional_with_lm(
        Kmn=Kmn, Lm=Lm, Knn=Knn, f=f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )


def base_conditional_with_lm(
    Kmn: torch.Tensor,
    Lm: torch.Tensor,
    Knn: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
    Lm_inv: Optional[torch.Tensor] = None,
) -> MeanAndVariance:
    """As ``base_conditional``, from the Cholesky factor Lm of Kmm; ``Lm_inv``
    optionally supplies Lm^-1."""
    num_func = f.shape[-1]  # R
    N = Kmn.shape[-1]
    M = f.shape[-2]

    # move leading dims in front: [M, ..., N] -> [..., M, N]
    K = Kmn.ndim
    Kmn = Kmn.permute(tuple(range(1, K - 1)) + (0, K - 1))
    leading_dims = Kmn.shape[:-2]

    Lm_b = Lm.expand(leading_dims + Lm.shape)  # [..., M, M]
    if Lm_inv is not None:
        Lm_inv = Lm_inv.expand(leading_dims + Lm_inv.shape[-2:])
        A = torch.matmul(Lm_inv, Kmn)  # [..., M, N]
    elif _use_inv_solve() and N > M:
        # invert L once ([M, M]) and broadcast the inverse
        Lm_inv = triangular_inverse(Lm).expand(leading_dims + Lm.shape)
        A = torch.matmul(Lm_inv, Kmn)
    else:
        A = torch.linalg.solve_triangular(Lm_b, Kmn, upper=False)

    if full_cov:
        fvar = Knn - torch.matmul(A.mT, A)  # [..., N, N]
        fvar = fvar.unsqueeze(-3).expand(leading_dims + (num_func, N, N))  # [..., R, N, N]
    else:
        fvar = Knn - torch.sum(torch.square(A), dim=-2)  # [..., N]
        fvar = fvar.unsqueeze(-2).expand(leading_dims + (num_func, N))  # [..., R, N]

    if not white:
        if Lm_inv is not None:
            A = torch.matmul(Lm_inv.mT, A)  # Lm^-T A
        else:
            A = torch.linalg.solve_triangular(Lm_b.mT, A, upper=True)

    f_b = f.expand(leading_dims + (M, num_func))
    fmean = torch.matmul(A.mT, f_b)  # [..., N, R]

    if q_sqrt is not None:
        if q_sqrt.ndim == 2:
            # diagonal [M, R] -> LTA [..., R, M, N]
            LTA = A[..., None, :, :] * q_sqrt.T[:, :, None]
        elif q_sqrt.ndim == 3:
            L = torch.tril(q_sqrt)  # [R, M, M]
            L_b = L.expand(leading_dims + L.shape)
            A_tiled = A.unsqueeze(-3).expand(leading_dims + (num_func, M, N))
            LTA = torch.matmul(L_b.mT, A_tiled)  # [..., R, M, N]
        else:
            raise ValueError(f"Bad dimension for q_sqrt: {q_sqrt.ndim}")

        if full_cov:
            fvar = fvar + torch.matmul(LTA.mT, LTA)  # [..., R, N, N]
        else:
            fvar = fvar + torch.sum(torch.square(LTA), dim=-2)  # [..., R, N]

    if not full_cov:
        fvar = fvar.mT  # [..., N, R]

    return fmean, fvar


def expand_independent_outputs(
    fvar: torch.Tensor, full_cov: bool, full_output_cov: bool
) -> torch.Tensor:
    """Single-output covariance in multi-output layout: [P, N, N] ->
    [N, P, N, P] with full_cov and full_output_cov, [N, P] -> [N, P, P] with
    full_output_cov only, unchanged otherwise."""
    if full_cov and full_output_cov:
        P = fvar.shape[-3]
        fvarT = fvar.transpose(-3, -1).transpose(-3, -2)  # [N, N, P]
        diag = fvarT[..., :, None] * torch.eye(P, dtype=fvar.dtype, device=fvar.device)
        return diag.transpose(-3, -2)  # [N, P, N, P]
    if not full_cov and full_output_cov:
        P = fvar.shape[-1]
        return fvar[..., :, None] * torch.eye(P, dtype=fvar.dtype, device=fvar.device)
    return fvar

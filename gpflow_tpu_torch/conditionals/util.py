"""Gaussian conditionals (counterpart of ``gpflow_tpu/conditionals/util.py``).

``base_conditional_with_lm``: A = Lm^-1 Kmn; fvar = Knn - A^T A, plus the
q_sqrt term; an extra back-solve when not whitened.

The INV_SOLVE route (``set_inv_solve``/``inv_solve``) replaces the wide
[M, N] triangular solve by one [M, M] inversion and matmuls when N > M.

The multioutput conditionals: ``separate_independent_conditional_implementation``
runs P single-output conditionals as one batched computation over [P, M, M]
(one batched Cholesky, batched solves or inverses), where the JAX package
maps ``base_conditional`` over P; ``independent_interdomain_conditional``
takes L latent processes through the interdomain Kuf [M, L, N, P];
``fully_correlated_conditional(_repeat)`` one [M, M] Kmm over the flattened
outputs; ``mix_latent_gp`` the moments of f = W g.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Optional, Union

import torch

from .._compile import randn
from ..base import MeanAndVariance, array_inputs
from ..config import default_jitter
from ..ops.linalg import chol_and_inverse, cholesky, triangular_inverse
from ..quadrature.gauss_hermite import canonical_device
from ..utilities.ops import leading_transpose
from ..utilities.shapes import check_shapes

__all__ = [
    "base_conditional",
    "base_conditional_with_lm",
    "default_generator",
    "expand_independent_outputs",
    "fully_correlated_conditional",
    "fully_correlated_conditional_repeat",
    "independent_interdomain_conditional",
    "inv_solve",
    "mix_latent_gp",
    "rollaxis_left",
    "rollaxis_right",
    "sample_mvn",
    "separate_independent_conditional_implementation",
    "set_inv_solve",
]

_inv_solve_state: list = []  # [] = the environment's setting; [bool] = set explicitly


def set_inv_solve(value: Optional[bool]) -> None:
    """Turns the INV_SOLVE route on (True) or off (False); None restores the
    default, ``GPFLOW_TPU_INV_SOLVE`` (off unless set to other than "0",
    "false" or "False"). Read at every call of the conditionals."""
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
    if _inv_solve_state:
        return _inv_solve_state[0]
    return os.environ.get("GPFLOW_TPU_INV_SOLVE", "0") not in ("0", "false", "False")


@array_inputs("Kmn", "Kmm", "Knn", "f", "q_sqrt")
@check_shapes(
    "Kmn: [M, batch..., N]",
    "Kmm: [M, M]",
    "Knn: [batch..., N, N] if full_cov",
    "Knn: [batch..., N] if not full_cov",
    "f: [M, R]",
    "return[0]: [batch..., N, R]",
    "return[1]: [batch..., R, N, N] if full_cov",
    "return[1]: [batch..., N, R] if not full_cov",
)
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


@array_inputs("Kmn", "Lm", "Knn", "f", "q_sqrt", "Lm_inv")
@check_shapes(
    "Kmn: [M, batch..., N]",
    "Lm: [M, M]",
    "Knn: [batch..., N, N] if full_cov",
    "Knn: [batch..., N] if not full_cov",
    "f: [M, R]",
    "return[0]: [batch..., N, R]",
    "return[1]: [batch..., R, N, N] if full_cov",
    "return[1]: [batch..., N, R] if not full_cov",
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


_default_generators: Dict[torch.device, torch.Generator] = {}


def default_generator(device: Union[str, torch.device]) -> torch.Generator:
    """The generator of the draws on ``device`` when the caller passes none:
    one per device, seeded 0 when first needed and advanced by every draw
    after, as the JAX package advances a seed counter
    (``gpflow_tpu/conditionals/util.py:88-111``)."""
    key = canonical_device(device)
    if key not in _default_generators:
        _default_generators[key] = torch.Generator(device=key).manual_seed(0)
    return _default_generators[key]


@array_inputs("mean", "cov")
@check_shapes(
    "mean: [batch..., N, D]",
    "cov: [batch..., N, D, D] if full_cov",
    "cov: [batch..., N, D] if not full_cov",
    "return: [batch..., S, N, D] if num_samples",
    "return: [batch..., N, D] if not num_samples",
)
def sample_mvn(
    mean: torch.Tensor,
    cov: torch.Tensor,
    full_cov: bool,
    num_samples: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Draws from batched D-dimensional normals (``gpflow_tpu/conditionals/util.py:271-305``):
    mean [..., N, D], cov [..., N, D, D] (full_cov, factored with the
    default jitter; NaN where the Cholesky fails) or [..., N, D]; returns
    [..., (S,) N, D]. The standard normal draws come from ``generator``,
    else from ``default_generator`` of the mean's device, so that two calls
    without one draw anew."""
    S = 1 if num_samples is None else num_samples
    if full_cov:
        eps_shape = mean.shape + (S,)  # [..., N, D, S]
    else:
        eps_shape = mean.shape[:-2] + (S,) + mean.shape[-2:]  # [..., S, N, D]
    if generator is None:
        generator = default_generator(mean.device)
    eps = randn(eps_shape, generator=generator, dtype=mean.dtype, device=mean.device)
    return _sample_mvn_with_eps(mean, cov, full_cov, eps, num_samples)


def _sample_mvn_with_eps(
    mean: torch.Tensor, cov: torch.Tensor, full_cov: bool, eps: torch.Tensor, num_samples: Optional[int]
) -> torch.Tensor:
    """``sample_mvn`` from the standard normal draws ``eps``, [..., N, D, S]
    with full_cov, else [..., S, N, D]."""
    if full_cov:
        D = mean.shape[-1]
        chol = cholesky(cov + default_jitter() * torch.eye(D, dtype=cov.dtype, device=cov.device))  # [..., N, D, D]
        samples = mean[..., None] + torch.matmul(chol, eps)  # [..., N, D, S]
        samples = leading_transpose(samples, [..., -1, -3, -2])  # [..., S, N, D]
    else:
        samples = mean[..., None, :, :] + torch.sqrt(cov)[..., None, :, :] * eps
    if num_samples is None:
        return samples.squeeze(-3)
    return samples


@array_inputs("fvar")
@check_shapes(
    "fvar: [batch..., P, N, N] if full_cov",
    "fvar: [batch..., N, P] if not full_cov",
)
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


@array_inputs("Kmn", "Kmm", "Knn", "f", "q_sqrt")
@check_shapes(
    "Kmn: [M, L, N, P]",
    "Kmm: [L, M, M]",
    "f: [M, L]",
    "return[0]: [N, P]",
)
def independent_interdomain_conditional(
    Kmn: torch.Tensor,
    Kmm: torch.Tensor,
    Knn: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Interdomain conditional with L latent processes
    (``gpflow_tpu/conditionals/util.py:334-398``).

    Kmn: [M, L, N, P], Kmm: [L, M, M], f: [M, L], q_sqrt: [M, L] or [L, M, M].
    """
    M, L, N, P = Kmn.shape

    Lm = cholesky(Kmm)  # [L, M, M]
    Kmn_r = Kmn.permute(1, 0, 2, 3).reshape(L, M, N * P)
    A = torch.linalg.solve_triangular(Lm, Kmn_r, upper=False)  # [L, M, N*P]
    Ar = A.reshape(L, M, N, P)

    if full_cov and full_output_cov:
        fvar = Knn - torch.tensordot(Ar, Ar, dims=([0, 1], [0, 1]))  # [N, P, N, P]
    elif full_cov:
        At = Ar.permute(3, 2, 1, 0).reshape(P, N, M * L)
        fvar = Knn - torch.matmul(At, At.mT)  # [P, N, N]
    elif full_output_cov:
        At = Ar.permute(2, 3, 1, 0).reshape(N, P, M * L)
        fvar = Knn - torch.matmul(At, At.mT)  # [N, P, P]
    else:
        fvar = Knn - torch.sum(torch.square(A), dim=(0, 1)).reshape(N, P)

    if not white:
        A = torch.linalg.solve_triangular(Lm.mT, A, upper=True)
        Ar = A.reshape(L, M, N, P)

    fmean = torch.tensordot(Ar, f, dims=([1, 0], [0, 1]))  # [N, P]

    if q_sqrt is not None:
        if q_sqrt.ndim == 3:
            LTA = torch.matmul(torch.tril(q_sqrt).mT, A)  # [L, M, N*P]
        else:  # [M, L]
            LTA = A * q_sqrt.mT[..., None]  # [L, M, N*P]

        if full_cov and full_output_cov:
            LTAr = LTA.reshape(L * M, N * P)
            fvar = fvar + torch.matmul(LTAr.mT, LTAr).reshape(N, P, N, P)
        elif full_cov:
            LTAr = LTA.reshape(L * M, N, P).permute(2, 0, 1)  # [P, LM, N]
            fvar = fvar + torch.matmul(LTAr.mT, LTAr)  # [P, N, N]
        elif full_output_cov:
            LTAr = LTA.reshape(L * M, N, P).permute(1, 0, 2)  # [N, LM, P]
            fvar = fvar + torch.matmul(LTAr.mT, LTAr)  # [N, P, P]
        else:
            fvar = fvar + torch.sum(torch.square(LTA), dim=(0, 1)).reshape(N, P)

    return fmean, fvar


@array_inputs("Kmn", "Kmm", "Knn", "f", "q_sqrt")
@check_shapes(
    "Kmn: [M, N, P]",
    "Kmm: [M, M]",
    "f: [M, 1]",
    "return[0]: [N, P]",
)
def fully_correlated_conditional(
    Kmn: torch.Tensor,
    Kmm: torch.Tensor,
    Knn: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Fully correlated multioutput conditional
    (``gpflow_tpu/conditionals/util.py:404-424``): Kmn [M, N, P], Kmm [M, M],
    f [M, 1]."""
    mean, var = fully_correlated_conditional_repeat(
        Kmn, Kmm, Knn, f, full_cov=full_cov, full_output_cov=full_output_cov, q_sqrt=q_sqrt, white=white,
    )
    return mean.squeeze(0), var.squeeze(0)


@array_inputs("Kmn", "Kmm", "Knn", "f", "q_sqrt")
@check_shapes(
    "Kmn: [M, N, P]",
    "Kmm: [M, M]",
    "f: [M, R]",
    "return[0]: [R, N, P]",
)
def fully_correlated_conditional_repeat(
    Kmn: torch.Tensor,
    Kmm: torch.Tensor,
    Knn: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """As ``fully_correlated_conditional`` for R repetitions in f and q_sqrt
    (``gpflow_tpu/conditionals/util.py:430-494``); f [M, R]."""
    R = f.shape[1]
    M, N, P = Kmn.shape

    Lm = cholesky(Kmm)
    A = torch.linalg.solve_triangular(Lm, Kmn.reshape(M, N * P), upper=False)  # [M, N*P]
    Ar = A.reshape(M, N, P)

    if full_cov and full_output_cov:
        fvar = Knn - torch.tensordot(Ar, Ar, dims=([0], [0]))  # [N, P, N, P]
    elif full_cov:
        At = Ar.permute(2, 1, 0)  # [P, N, M]
        fvar = Knn - torch.matmul(At, At.mT)  # [P, N, N]
    elif full_output_cov:
        At = Ar.permute(1, 0, 2)  # [N, M, P]
        fvar = Knn - torch.matmul(At.mT, At)  # [N, P, P]
    else:
        fvar = Knn - torch.sum(torch.square(A), dim=0).reshape(N, P)

    if not white:
        A = torch.linalg.solve_triangular(Lm.mT, A, upper=True)  # [M, N*P]

    fmean = torch.matmul(f.mT, A).reshape(R, N, P)

    if q_sqrt is not None:
        A_tiled = A[None, :, :].expand(R, M, N * P)
        if q_sqrt.ndim == 3:
            LTA = torch.matmul(torch.tril(q_sqrt).mT, A_tiled)  # [R, M, N*P]
        elif q_sqrt.ndim == 2:
            LTA = q_sqrt.mT[:, :, None] * A_tiled  # [R, M, N*P]
        else:
            raise ValueError(f"Bad dimension for q_sqrt: {q_sqrt.ndim}")

        if full_cov and full_output_cov:
            addvar = torch.matmul(LTA.mT, LTA)  # [R, NP, NP]
            fvar = fvar[None] + addvar.reshape(R, N, P, N, P)
        elif full_cov:
            LTAr = LTA.reshape(R, M, N, P).permute(0, 3, 1, 2)  # [R, P, M, N]
            fvar = fvar[None] + torch.matmul(LTAr.mT, LTAr)  # [R, P, N, N]
        elif full_output_cov:
            LTAr = LTA.reshape(R, M, N, P).permute(0, 2, 3, 1)  # [R, N, P, M]
            fvar = fvar[None] + torch.matmul(LTAr, LTAr.mT)  # [R, N, P, P]
        else:
            fvar = fvar[None] + torch.sum(torch.square(LTA), dim=1).reshape(R, N, P)
    else:
        fvar = fvar[None].expand((R,) + fvar.shape)

    return fmean, fvar


@array_inputs("A")
@check_shapes(
    "A: [left..., right...]",
    "return: [right..., left...]",
)
def rollaxis_left(A: torch.Tensor, num_rolls: int) -> torch.Tensor:
    """Rolls the ``num_rolls`` leading axes to the back."""
    assert num_rolls > 0
    rank = A.ndim
    return A.permute(tuple(range(num_rolls, rank)) + tuple(range(num_rolls)))


@array_inputs("A")
@check_shapes(
    "A: [left..., right...]",
    "return: [right..., left...]",
)
def rollaxis_right(A: torch.Tensor, num_rolls: int) -> torch.Tensor:
    """Rolls the ``num_rolls`` trailing axes to the front."""
    assert num_rolls > 0
    rank = A.ndim
    return A.permute(tuple(range(rank - num_rolls, rank)) + tuple(range(rank - num_rolls)))


@array_inputs("W", "g_mean", "g_var")
@check_shapes(
    "W: [P, L]",
    "g_mean: [batch..., N, L]",
    "g_var: [L, batch..., N, N] if full_cov",
    "g_var: [batch..., N, L] if not full_cov",
    "return[0]: [batch..., N, P]",
)
def mix_latent_gp(
    W: torch.Tensor,
    g_mean: torch.Tensor,
    g_var: torch.Tensor,
    full_cov: bool,
    full_output_cov: bool,
) -> MeanAndVariance:
    """Moments of f = W g for uncorrelated latent g
    (``gpflow_tpu/conditionals/util.py:528-565``): W [P, L], g_mean
    [..., N, L], g_var [..., N, L] or, with full_cov, [L, ..., N, N]."""
    f_mean = torch.tensordot(g_mean, W, dims=([g_mean.ndim - 1], [1]))  # [..., N, P]

    if full_cov and full_output_cov:  # g_var: [L, ..., N, N]
        g_var_W = rollaxis_left(g_var, 1).unsqueeze(-2) * W  # [..., N, N, P, L]
        f_var = torch.tensordot(g_var_W, W, dims=([g_var_W.ndim - 1], [1]))  # [..., N, N, P, P]
        f_var = leading_transpose(f_var, [..., -4, -2, -3, -1])  # [..., N, P, N, P]
    elif full_cov:  # g_var: [L, ..., N, N]
        f_var = torch.tensordot(g_var, W ** 2, dims=([0], [1]))  # [..., N, N, P]
        f_var = leading_transpose(f_var, [..., -1, -3, -2])  # [..., P, N, N]
    elif full_output_cov:  # g_var: [..., N, L]
        g_var_W = g_var.unsqueeze(-2) * W  # [..., N, P, L]
        f_var = torch.tensordot(g_var_W, W, dims=([g_var_W.ndim - 1], [1]))  # [..., N, P, P]
    else:  # g_var: [..., N, L]
        f_var = torch.tensordot(g_var, W ** 2, dims=([g_var.ndim - 1], [1]))  # [..., N, P]

    return f_mean, f_var


@array_inputs("Kmns", "Kmms", "Knns", "f", "q_sqrt")
@check_shapes(
    "Kmns: [P, M, batch..., N]",
    "Kmms: [P, M, M]",
    "Knns: [P, batch..., N, N] if full_cov",
    "Knns: [P, batch..., N] if not full_cov",
    "f: [M, P]",
    "return[0]: [batch..., N, P]",
    "return[1]: [P, batch..., N, N] if full_cov",
    "return[1]: [batch..., N, P] if not full_cov",
)
def separate_independent_conditional_implementation(
    Kmns: torch.Tensor,
    Kmms: torch.Tensor,
    Knns: torch.Tensor,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """P independent single-output conditionals, output p from Kmms[p],
    Kmns[p], Knns[p], f[:, p] and q_sqrt's p-th column or matrix
    (``gpflow_tpu/conditionals/util.py:571-616``, which maps
    ``base_conditional`` over P). Here they are one batched computation:
    one Cholesky of the [P, M, M] stack, and batched triangular solves, or on
    the INV_SOLVE route (N > M) one batched inverse and matmuls, with the
    same arithmetic per output as ``base_conditional``.

    Kmns: [P, M, batch..., N], Kmms: [P, M, M], Knns: [P, batch..., N, N] or
    [P, batch..., N], f: [M, P], q_sqrt: [M, P] or [P, M, M]. Returns fmu
    [batch..., N, P] and fvar [P, batch..., N, N] or [batch..., N, P].
    """
    P, M, N = Kmms.shape[0], Kmms.shape[-1], Kmns.shape[-1]
    Kmn = torch.movedim(Kmns, 1, -2)  # [P, batch..., M, N]
    shape = Kmn.shape[:-2] + (M, M)  # [P, batch..., M, M]
    ones = (1,) * (Kmn.ndim - 3)

    def per_output(T: torch.Tensor) -> torch.Tensor:
        """[P, M, M] -> [P, batch..., M, M], a view."""
        return T.reshape((P,) + ones + (M, M)).expand(shape)

    if _use_inv_solve() and N > M:
        _, Lm_inv = chol_and_inverse(Kmms)
        Lm_inv = per_output(Lm_inv)
        A = torch.matmul(Lm_inv, Kmn)  # [P, batch..., M, N]
    else:
        Lm_inv = None
        Lm = per_output(cholesky(Kmms))
        A = torch.linalg.solve_triangular(Lm, Kmn, upper=False)

    if full_cov:
        fvar = Knns - torch.matmul(A.mT, A)  # [P, batch..., N, N]
    else:
        fvar = Knns - torch.sum(torch.square(A), dim=-2)  # [P, batch..., N]

    if not white:
        A = torch.matmul(Lm_inv.mT, A) if Lm_inv is not None else torch.linalg.solve_triangular(Lm.mT, A, upper=True)

    fs = f.mT.reshape((P,) + ones + (M, 1))
    fmean = torch.matmul(A.mT, fs)[..., 0]  # [P, batch..., N]

    if q_sqrt is not None:
        if q_sqrt.ndim == 2:  # [M, P]
            LTA = A * q_sqrt.mT.reshape((P,) + ones + (M, 1))
        else:  # [P, M, M]
            LTA = torch.matmul(per_output(torch.tril(q_sqrt)).mT, A)  # [P, batch..., M, N]
        if full_cov:
            fvar = fvar + torch.matmul(LTA.mT, LTA)
        else:
            fvar = fvar + torch.sum(torch.square(LTA), dim=-2)

    fmu = torch.movedim(fmean, 0, -1)  # [batch..., N, P]
    if not full_cov:
        fvar = torch.movedim(fvar, 0, -1)  # [batch..., N, P]
    return fmu, fvar

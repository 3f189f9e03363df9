"""KL divergences (counterpart of ``gpflow_tpu/kullback_leiblers.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from .config import default_jitter
from .covariances import Kuu
from .inducing_variables import InducingVariables
from .kernels import Kernel
from .ops.linalg import cholesky
from .utilities import Dispatcher
from .utilities.shapes import check_shapes

__all__ = ["gauss_kl", "prior_kl"]

prior_kl = Dispatcher("prior_kl")


@prior_kl.register(InducingVariables, Kernel, object, object)
@check_shapes(
    "inducing_variable: [N, D, broadcast L]",
    "q_mu: [M, L]",
    "q_sqrt: [M, L] | [L, M, M]",
    "return: []",
)
def _prior_kl_default(
    inducing_variable: InducingVariables,
    kernel: Kernel,
    q_mu: torch.Tensor,
    q_sqrt: torch.Tensor,
    whiten: bool = False,
) -> torch.Tensor:
    """Whitened: KL to N(0, I); else KL to N(0, Kuu) (``kullback_leiblers.py:21-51``)."""
    if whiten:
        return gauss_kl(q_mu, q_sqrt, None)
    K = Kuu(inducing_variable, kernel, jitter=default_jitter())  # [L, M, M] or [M, M]
    if K.ndim == 4:
        # the fully correlated route (InducingPoints and a multioutput
        # kernel): q_mu and q_sqrt are over the row-major flattened [MP]
        # vector, so the prior is N(0, Kuu as [MP, MP]) (``:42-51``)
        MP = K.shape[0] * K.shape[1]
        K = K.reshape(MP, MP)
    return gauss_kl(q_mu, q_sqrt, K)


@check_shapes(
    "q_mu: [M, L]",
    "q_sqrt: [M, L] | [L, M, M]",
    "return: []",
)
def gauss_kl(
    q_mu: torch.Tensor,
    q_sqrt: torch.Tensor,
    K: Optional[torch.Tensor] = None,
    *,
    K_cholesky: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KL[q || p] for q = N(q_mu, q_sqrt q_sqrt^T) and p = N(0, K), or
    N(0, I) where K and K_cholesky are both None, summed over the L
    independent distributions in the columns of q_mu
    (``kullback_leiblers.py:53-140``).

    q_mu: [M, L]; q_sqrt: [M, L] (diagonal) or [L, M, M] (lower triangular);
    K / K_cholesky: [M, M] or [L, M, M]. A K that is not positive definite
    gives NaN."""
    if (K is not None) and (K_cholesky is not None):
        raise ValueError(
            "Ambiguous arguments: gauss_kl() must only be passed one of `K` or `K_cholesky`."
        )
    is_white = (K is None) and (K_cholesky is None)
    is_diag = q_sqrt.ndim == 2
    M, L = q_mu.shape

    if is_white:
        alpha = q_mu  # [M, L]
        is_batched = False
    else:
        Lp = cholesky(K) if K is not None else K_cholesky  # [L, M, M] or [M, M]
        is_batched = Lp.ndim == 3
        q_mu_p = q_mu.mT[:, :, None] if is_batched else q_mu  # [L, M, 1] or [M, L]
        alpha = torch.linalg.solve_triangular(Lp, q_mu_p, upper=False)

    if is_diag:
        Lq_diag = q_sqrt  # [M, L]
        Lq_sq_sum = torch.sum(torch.square(q_sqrt))
        Lq_full = torch.diag_embed(q_sqrt.mT)  # [L, M, M]
    else:
        Lq_full = torch.tril(q_sqrt)  # [L, M, M]
        Lq_diag = torch.diagonal(Lq_full, dim1=-2, dim2=-1).mT  # [M, L]
        Lq_sq_sum = torch.sum(torch.square(Lq_full))

    mahalanobis = torch.sum(torch.square(alpha))  # mu_q^T Sigma_p^-1 mu_q
    constant = -float(M * L)
    logdet_qcov = torch.sum(torch.log(torch.square(Lq_diag)))

    # trace term tr(Sigma_p^-1 Sigma_q)
    if is_white:
        trace = Lq_sq_sum
    elif is_diag and not is_batched:
        # K [M, M] with a diagonal q_sqrt [M, L]: only diag(K^-1) is needed
        eye = torch.eye(M, dtype=Lp.dtype, device=Lp.device)
        Lp_inv = torch.linalg.solve_triangular(Lp, eye, upper=False)
        K_inv_diag = torch.diagonal(torch.linalg.solve_triangular(Lp.mT, Lp_inv, upper=True))[:, None]
        trace = torch.sum(K_inv_diag * torch.square(q_sqrt))
    else:
        Lp_full = Lp if is_batched else Lp.expand(L, M, M)
        trace = torch.sum(torch.square(torch.linalg.solve_triangular(Lp_full, Lq_full, upper=False)))

    twoKL = mahalanobis + constant - logdet_qcov + trace

    if not is_white:  # log-determinant of the prior covariance
        sum_log_sqdiag_Lp = torch.sum(torch.log(torch.square(torch.diagonal(Lp, dim1=-2, dim2=-1))))
        scale = 1.0 if is_batched else float(L)
        twoKL = twoKL + scale * sum_log_sqdiag_Lp

    return 0.5 * twoKL

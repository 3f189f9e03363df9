"""The conditional at uncertain inputs (counterpart of
``gpflow_tpu/conditionals/uncertain_conditionals.py``): the moments of f(x)
under q(u), marginalised over x ~ N(Xnew_mu, Xnew_var), from the psi
statistics. Its [N, M, M] psi2 is solved against Luu as one batch, so its
memory grows as N M^2."""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MeanAndVariance, array_inputs
from ..config import default_jitter
from ..covariances import Kuu
from ..expectations import expectation
from ..functions import MeanFunction, Zero
from ..inducing_variables import InducingPoints, InducingVariables
from ..kernels import Kernel
from ..ops.linalg import cholesky
from ..probability_distributions import Gaussian
from ..utilities.shapes import check_shapes

__all__ = ["uncertain_conditional"]


def _solve_lower(L: torch.Tensor, B: torch.Tensor, left_transpose: bool = False) -> torch.Tensor:
    """L^-1 B, or L^-T B with ``left_transpose``."""
    return torch.linalg.solve_triangular(L.mT if left_transpose else L, B, upper=left_transpose)


@array_inputs("Xnew_mu", "Xnew_var", "q_mu", "q_sqrt")
@check_shapes(
    "Xnew_mu: [batch..., N, Din]",
    "Xnew_var: [batch..., N, n, n]",
    "inducing_variable: [M, Din, maybe_t...]",
    "q_mu: [M, Dout]",
    "q_sqrt: [t, M, M]",
    "return[0]: [batch..., N, Dout]",
    "return[1]: [batch..., N, t, t] if full_output_cov",
    "return[1]: [batch..., N, Dout] if not full_output_cov",
)
def uncertain_conditional(
    Xnew_mu: torch.Tensor,
    Xnew_var: torch.Tensor,
    inducing_variable: InducingVariables,
    kernel: Kernel,
    q_mu: torch.Tensor,
    q_sqrt: torch.Tensor,
    *,
    mean_function: Optional[MeanFunction] = None,
    full_output_cov: bool = False,
    full_cov: bool = False,
    white: bool = False,
) -> MeanAndVariance:
    """Mean [N, Dout] and variance [N, Dout] (or [N, Dout, Dout] with
    ``full_output_cov``) of f at Xnew ~ N(Xnew_mu [N, Din], Xnew_var
    [N, Din, Din]), with q(u) = N(q_mu [M, Dout], q_sqrt q_sqrt^T)
    (q_sqrt [Dout, M, M])."""
    if not isinstance(inducing_variable, InducingPoints):
        raise NotImplementedError
    if full_cov:
        raise NotImplementedError("uncertain_conditional() currently does not support full_cov=True")

    pXnew = Gaussian(Xnew_mu, Xnew_var)

    num_data = Xnew_mu.shape[0]  # N
    num_ind, num_func = q_mu.shape  # M, Dout
    q_sqrt_r = torch.tril(q_sqrt)  # [Dout, M, M]

    eKuf = expectation(pXnew, (kernel, inducing_variable)).mT  # [M, N] (psi1)
    Luu = cholesky(Kuu(inducing_variable, kernel, jitter=default_jitter()))  # [M, M]

    if not white:
        q_mu = _solve_lower(Luu, q_mu)
        q_sqrt_r = _solve_lower(Luu.expand((num_func,) + Luu.shape), q_sqrt_r)

    Li_eKuf = _solve_lower(Luu, eKuf)  # [M, N]
    fmean = Li_eKuf.mT @ q_mu

    eKff = expectation(pXnew, kernel)  # [N] (psi0)
    eKuffu = expectation(pXnew, (kernel, inducing_variable), (kernel, inducing_variable))  # [N, M, M] (psi2)
    Luu_tiled = Luu.expand((num_data,) + Luu.shape)
    Li_eKuffu = _solve_lower(Luu_tiled, eKuffu)
    Li_eKuffu_Lit = _solve_lower(Luu_tiled, Li_eKuffu.mT)  # [N, M, M]
    cov = torch.matmul(q_sqrt_r, q_sqrt_r.mT)  # [Dout, M, M]

    if mean_function is None or isinstance(mean_function, Zero):
        e_related_to_mean = torch.zeros((num_data, num_func, num_func), dtype=fmean.dtype, device=fmean.device)
    else:
        fmean = fmean + expectation(pXnew, mean_function)
        e_mean_mean = expectation(pXnew, mean_function, mean_function)  # [N, Dout, Dout]
        Lit_q_mu = _solve_lower(Luu, q_mu, left_transpose=True)
        e_mean_Kuf = expectation(pXnew, mean_function, (kernel, inducing_variable))  # [N, Dout, M]
        e_mean_Kuf = e_mean_Kuf.reshape(num_data, num_func, num_ind)
        e_fmean_mean = torch.einsum("nqm,mz->nqz", e_mean_Kuf, Lit_q_mu)  # [N, Dout, Dout]
        e_related_to_mean = e_fmean_mean + e_fmean_mean.mT + e_mean_mean

    trace_term = torch.diagonal(Li_eKuffu_Lit, dim1=-2, dim2=-1).sum(-1)  # [N]
    q_cov_term = torch.einsum("nij,dji->nd", Li_eKuffu_Lit, cov)  # [N, Dout]

    if full_output_cov:
        fvar = (
            torch.diag_embed((eKff - trace_term)[:, None].expand(num_data, num_func))
            + torch.diag_embed(q_cov_term)
            + torch.einsum("ig,nij,jh->ngh", q_mu, Li_eKuffu_Lit, q_mu)
            - fmean[:, :, None] * fmean[:, None, :]
            + e_related_to_mean
        )
    else:
        fvar = (
            (eKff - trace_term)[:, None]
            + q_cov_term
            + torch.einsum("ig,nij,jg->ng", q_mu, Li_eKuffu_Lit, q_mu)
            - fmean ** 2
            + torch.diagonal(e_related_to_mean, dim1=-2, dim2=-1)
        )

    return fmean, fvar

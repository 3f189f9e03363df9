"""Sparse GP regression (counterpart of ``gpflow_tpu/models/sgpr.py``): SGPR
(Titsias 2009) with its collapsed ELBO and the Titsias (2014) upper bound,
and GPRFITC (Snelson & Ghahramani 2006), in the JAX package's layers
``SGPRBase_deprecated`` -> ``SGPR_deprecated`` (fused prediction) ->
``SGPR_with_posterior`` (cached posterior) -> ``SGPR``.

On a CUDA device Kuu and Kuf come from kernel K1 and, for the exponential
and Matern kernels, their gradients from K2 (``ops/pallas_distance.py``).
The [M, M] Choleskys go through ``ops.linalg.cholesky``, which gives NaN
where its input is not positive definite, as ``jnp.linalg.cholesky`` does:
a float32 trial point of L-BFGS whose B is indefinite then reaches
``Scipy``'s ``nonfinite_penalty`` instead of raising. The triangular solves
and matmuls go to cuBLAS through ``torch.linalg``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .. import posteriors
from .._sharding import rows_of, share_blocks
from ..base import MeanAndVariance, input_to_tensor
from ..config import default_jitter
from ..covariances import Kuf, Kuu
from ..functions import MeanFunction
from ..kernels import Kernel
from ..likelihoods import Gaussian
from ..ops.linalg import cholesky
from ..utilities.model_utils import add_noise_cov, assert_params_false
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin, RegressionData
from .util import data_input_to_tensor, inducingpoint_wrapper

__all__ = ["GPRFITC", "SGPR", "SGPRBase_deprecated", "SGPR_deprecated", "SGPR_with_posterior"]


class SGPRBase_deprecated(GPModel, InternalDataTrainingLossMixin):
    """Common base of SGPR and GPRFITC: construction and the Titsias upper
    bound (``gpflow_tpu/models/sgpr.py:32-107``).

    ``data`` is (X [N, D], Y [N, P]); it is stored as tensors of the default
    float type on ``config.default_device()``, as are the inducing points."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
        "noise_variance: []",
    )
    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        inducing_variable: Any,
        *,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
        noise_variance: Optional[Any] = None,
        likelihood: Optional[Gaussian] = None,
    ) -> None:
        if noise_variance is not None and likelihood is not None:
            raise ValueError("Cannot set both `noise_variance` and `likelihood`.")
        if likelihood is None:
            likelihood = Gaussian(1.0 if noise_variance is None else noise_variance)
        X_data, Y_data = data_input_to_tensor(data)
        num_latent_gps = Y_data.shape[-1] if num_latent_gps is None else num_latent_gps
        super().__init__(kernel, likelihood, mean_function, num_latent_gps=num_latent_gps)

        self.data = X_data, Y_data
        self.num_data = X_data.shape[0]
        self.inducing_variable = inducingpoint_wrapper(inducing_variable)

    @check_shapes(
        "return: []",
    )
    def upper_bound(self) -> torch.Tensor:
        """The Titsias (2014) upper bound on the log marginal likelihood
        (``sgpr.py:67-107``)."""
        X_data, Y_data = self.data
        rows = rows_of(self)

        sigma_sq = self.likelihood.variance_at(X_data).squeeze(-1)  # [N]
        sigma = torch.sqrt(sigma_sq)

        Kdiag = self.kernel(X_data, full_cov=False)
        kuu = Kuu(self.inducing_variable, self.kernel, jitter=default_jitter())
        kuf = Kuf(self.inducing_variable, self.kernel, X_data)

        I = torch.eye(kuu.shape[0], dtype=kuu.dtype, device=kuu.device)

        L = cholesky(kuu)
        A = torch.linalg.solve_triangular(L, kuf, upper=False)

        A_sigma = torch.linalg.solve_triangular(L, kuf / sigma, upper=False)
        AAT_sigma = rows.sum(A_sigma @ A_sigma.mT)
        B = I + AAT_sigma
        LB = cholesky(B)

        # the trace bound (Titsias' presentation)
        c = rows.sum(torch.sum(Kdiag) - torch.sum(torch.square(A)))

        cn_var = sigma_sq + c
        cn_std = torch.sqrt(cn_var)

        const = -0.5 * rows.sum(torch.sum(torch.log(2 * math.pi * sigma_sq)))
        logdet = -torch.sum(torch.log(torch.diagonal(LB)))

        A_cn = torch.linalg.solve_triangular(L, kuf / cn_std, upper=False)
        AAT_cn = rows.sum(A_cn @ A_cn.mT)

        err = Y_data - self.mean_function(X_data)
        LC = cholesky(I + AAT_cn)
        v = torch.linalg.solve_triangular(LC, rows.sum(A_cn @ (err / cn_std[:, None])), upper=False)
        quad = -0.5 * rows.sum(torch.sum(torch.square(err / cn_std[:, None]))) + 0.5 * torch.sum(torch.square(v))

        return const + logdet + quad


class SGPR_deprecated(SGPRBase_deprecated):
    """Sparse GP regression with the collapsed ELBO (``sgpr.py:110-269``)."""

    class CommonTensors(NamedTuple):
        sigma_sq: torch.Tensor
        sigma: torch.Tensor
        A: torch.Tensor
        B: torch.Tensor
        LB: torch.Tensor
        AAT: torch.Tensor
        L: torch.Tensor

    @check_shapes(
        "return: []",
    )
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.elbo()

    @check_shapes(
        "return.sigma_sq: [N]",
        "return.sigma: [N]",
        "return.A: [M, N]",
        "return.B: [M, M]",
        "return.LB: [M, M]",
        "return.AAT: [M, M]",
        "return.L: [M, M]",
    )
    def _common_calculation(self) -> "SGPR_deprecated.CommonTensors":
        """sigma, L = chol(Kuu), A = L^-1 Kuf / sigma [M, N], B = A A^T + I
        and LB = chol(B) (``sgpr.py:136-154``)."""
        x, _ = self.data
        iv = self.inducing_variable

        sigma_sq = self.likelihood.variance_at(x).squeeze(-1)  # [N]
        sigma = torch.sqrt(sigma_sq)

        kuf = Kuf(iv, self.kernel, x)  # [M, N]
        kuu = Kuu(iv, self.kernel, jitter=default_jitter())  # [M, M]
        L = cholesky(kuu)

        A = torch.linalg.solve_triangular(L, kuf / sigma, upper=False)
        AAT = rows_of(self).sum(A @ A.mT)
        B = add_noise_cov(AAT, 1.0)
        LB = cholesky(B)

        return self.CommonTensors(sigma_sq, sigma, A, B, LB, AAT, L)

    @check_shapes(
        "return: []",
    )
    def logdet_term(self, common: "SGPR_deprecated.CommonTensors") -> torch.Tensor:
        """The Jensen bound on -0.5 P log|K + sigma^2 I| (``sgpr.py:156-176``)."""
        sigma_sq = common.sigma_sq
        LB = common.LB
        AAT = common.AAT

        x, y = self.data
        outdim = float(y.shape[1])
        kdiag = self.kernel(x, full_cov=False)

        rows = rows_of(self)
        trace_k = rows.sum(torch.sum(kdiag / sigma_sq))
        trace_q = torch.sum(torch.diagonal(AAT))
        trace = trace_k - trace_q

        half_logdet_b = torch.sum(torch.log(torch.diagonal(LB)))
        log_sigma_sq = rows.sum(torch.sum(torch.log(sigma_sq)))

        return -outdim * (half_logdet_b + 0.5 * log_sigma_sq + 0.5 * trace)

    @check_shapes(
        "return: []",
    )
    def quad_term(self, common: "SGPR_deprecated.CommonTensors") -> torch.Tensor:
        """The lower bound on -0.5 y^T (K + sigma^2 I)^-1 y (``sgpr.py:178-195``)."""
        sigma = common.sigma
        A = common.A
        LB = common.LB

        x, y = self.data
        err = (y - self.mean_function(x)) / sigma[..., None]

        rows = rows_of(self)
        Aerr = rows.sum(A @ err)
        c = torch.linalg.solve_triangular(LB, Aerr, upper=False)

        err_inner_prod = rows.sum(torch.sum(torch.square(err)))
        c_inner_prod = torch.sum(torch.square(c))

        return -0.5 * (err_inner_prod - c_inner_prod)

    @check_shapes(
        "return: []",
    )
    def elbo(self) -> torch.Tensor:
        """The collapsed evidence lower bound (``sgpr.py:197-206``)."""
        common = self._common_calculation()
        num_data, output_dim = float(self.data[1].shape[0] * rows_of(self).size), float(self.data[1].shape[1])
        const = -0.5 * num_data * output_dim * math.log(2 * math.pi)
        logdet = self.logdet_term(common)
        quad = self.quad_term(common)
        return const + logdet + quad

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The posterior of f at Xnew, from Kuu, Kuf and K(Z, Xnew) on every
        call (``sgpr.py:208-245``)."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)

        X_data, Y_data = self.data
        err = Y_data - self.mean_function(X_data)
        common = self._common_calculation()
        c = torch.linalg.solve_triangular(
            common.LB, rows_of(self).sum(common.A @ (err / common.sigma[..., None])), upper=False
        )
        mean, var = posteriors.sgpr_conditional(
            self.kernel, self.inducing_variable, self.num_latent_gps, common.L, common.LB, c, Xnew, full_cov
        )
        return mean + self.mean_function(Xnew), var

    @check_shapes(
        "return[0]: [M, P]",
        "return[1]: [M, M]",
    )
    def compute_qu(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean [M, P] and covariance [M, M] of the implied q(u): an SVGP with
        this q(u) predicts as the SGPR does (``sgpr.py:247-269``)."""
        X_data, Y_data = self.data

        kuf = Kuf(self.inducing_variable, self.kernel, X_data)
        kuu = Kuu(self.inducing_variable, self.kernel, jitter=default_jitter())

        var = self.likelihood.variance_at(X_data).squeeze(-1)
        std = torch.sqrt(var)
        scaled_kuf = kuf / std
        rows = rows_of(self)
        sig = kuu + rows.sum(scaled_kuf @ scaled_kuf.mT)
        sig_sqrt = cholesky(sig)

        sig_sqrt_kuu = torch.linalg.solve_triangular(sig_sqrt, kuu, upper=False)

        cov = sig_sqrt_kuu.mT @ sig_sqrt_kuu
        err = Y_data - self.mean_function(X_data)
        scaled_err = err / std[..., None]
        mu = sig_sqrt_kuu.mT @ torch.linalg.solve_triangular(sig_sqrt, rows.sum(scaled_kuf @ scaled_err), upper=False)

        return mu, cov


class GPRFITC(SGPRBase_deprecated):
    """GP regression with the FITC approximation (``sgpr.py:272-363``)."""

    @check_shapes(
        "return[0]: [N, R]",
        "return[1]: [N]",
        "return[2]: [M, M]",
        "return[3]: [M, M]",
        "return[4]: [M, R]",
        "return[5]: [N, R]",
        "return[6]: [M, R]",
    )
    def common_terms(self) -> Tuple[torch.Tensor, ...]:
        """err [N, R], nu = Kdiag - diag(Qff) + sigma^2 [N], Luu [M, M],
        L = chol(I + V nu^-1 V^T) [M, M], alpha [M, R], beta [N, R] and
        gamma [M, R] (``sgpr.py:285-312``)."""
        X_data, Y_data = self.data
        err = Y_data - self.mean_function(X_data)  # [N, R]
        Kdiag = self.kernel(X_data, full_cov=False)
        kuf = Kuf(self.inducing_variable, self.kernel, X_data)
        kuu = Kuu(self.inducing_variable, self.kernel, jitter=default_jitter())

        sigma_sq = self.likelihood.variance_at(X_data).squeeze(-1)

        Luu = cholesky(kuu)
        V = torch.linalg.solve_triangular(Luu, kuf, upper=False)  # V^T V = Qff

        diagQff = torch.sum(torch.square(V), 0)
        nu = Kdiag - diagQff + sigma_sq

        rows = rows_of(self)
        B = add_noise_cov(rows.sum((V / nu) @ V.mT), 1.0)
        L = cholesky(B)
        beta = err / nu[:, None]  # [N, R]
        alpha = rows.sum(V @ beta)  # [M, R]

        gamma = torch.linalg.solve_triangular(L, alpha, upper=False)  # [M, R]

        return err, nu, Luu, L, alpha, beta, gamma

    @check_shapes(
        "return: []",
    )
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.fitc_log_marginal_likelihood()

    @check_shapes(
        "return: []",
    )
    def fitc_log_marginal_likelihood(self) -> torch.Tensor:
        """The FITC log marginal likelihood through the Woodbury identity and
        the determinant lemma (``sgpr.py:318-334``)."""
        err, nu, _Luu, L, _alpha, _beta, gamma = self.common_terms()

        rows = rows_of(self)
        mahalanobisTerm = -0.5 * rows.sum(torch.sum(torch.square(err) / nu[:, None])) + 0.5 * torch.sum(
            torch.square(gamma)
        )

        constantTerm = -0.5 * self.num_data * math.log(2.0 * math.pi)
        logDeterminantTerm = -0.5 * rows.sum(torch.sum(torch.log(nu))) - torch.sum(torch.log(torch.diagonal(L)))
        logNormalizingTerm = constantTerm + logDeterminantTerm

        return mahalanobisTerm + logNormalizingTerm * self.num_latent_gps

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """``sgpr.py:336-363``."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)

        _, _, Luu, L, _, _, gamma = self.common_terms()
        Kus = Kuf(self.inducing_variable, self.kernel, Xnew)  # [M, N]

        w = torch.linalg.solve_triangular(Luu, Kus, upper=False)  # [M, N]

        tmp = torch.linalg.solve_triangular(L.mT, gamma, upper=True)
        mean = w.mT @ tmp + self.mean_function(Xnew)
        intermediateA = torch.linalg.solve_triangular(L, w, upper=False)

        if full_cov:
            var = self.kernel(Xnew) - w.mT @ w + intermediateA.mT @ intermediateA
            var = var[None, ...].expand((self.num_latent_gps,) + var.shape)
        else:
            var = (
                self.kernel(Xnew, full_cov=False)
                - torch.sum(torch.square(w), 0)
                + torch.sum(torch.square(intermediateA), 0)
            )
            var = var[:, None].expand(var.shape + (self.num_latent_gps,))

        return mean, var


class SGPR_with_posterior(SGPR_deprecated):
    """Adds the cached posterior (``sgpr.py:366-389``)."""

    def posterior(
        self,
        precompute_cache: posteriors.PrecomputeCacheType = posteriors.PrecomputeCacheType.TENSOR,
    ) -> posteriors.SGPRPosterior:
        """The posterior, with its (L, LB, c, alpha) cache computed unless
        NOCACHE."""
        posterior = posteriors.SGPRPosterior(
            kernel=self.kernel,
            data=self.data,
            inducing_variable=self.inducing_variable,
            likelihood=self.likelihood,
            num_latent_gps=self.num_latent_gps,
            mean_function=self.mean_function,
            precompute_cache=None,
        )
        share_blocks(self, posterior)  # a split model's posterior sums its A A^T and A err over the ranks
        if precompute_cache is not None:
            posterior.update_cache(precompute_cache)
        return posterior

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The fused route: Kuu, Kuf and the two Choleskys on every call."""
        Xnew = input_to_tensor(self, Xnew)
        return self.posterior(posteriors.PrecomputeCacheType.NOCACHE).fused_predict_f(
            Xnew, full_cov=full_cov, full_output_cov=full_output_cov
        )


class SGPR(SGPR_with_posterior):
    """Sparse GP regression (Titsias 2009)."""

"""Exact Gaussian-process regression (counterpart of
``gpflow_tpu/models/gpr.py``), in the JAX package's three layers:
``GPR_deprecated`` (fused prediction) -> ``GPR_with_posterior`` (cached
posterior) -> ``GPR``.

On a CUDA device K(X) and K(X, Xnew) come from kernel K1 and, for the
exponential and Matern kernels, the gradient of K(X) from K2
(``ops/pallas_distance.py``); the O(N^3) factorizations, solves and matmuls
go to cuSOLVER and cuBLAS through ``torch.linalg``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from .. import posteriors
from .._sharding import kernel_rows, rows_of
from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..conditionals.util import _use_inv_solve, base_conditional
from ..functions import MeanFunction
from ..kernels import Kernel
from ..likelihoods import Gaussian
from ..logdensities import multivariate_normal
from ..ops.linalg import cholesky, mvn_logp
from ..utilities.model_utils import add_likelihood_noise_cov, assert_params_false
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin, RegressionData
from .util import data_input_to_tensor

__all__ = ["GPR", "GPR_deprecated", "GPR_with_posterior"]


class GPR_deprecated(GPModel, InternalDataTrainingLossMixin):
    """GPR with fused prediction (``gpflow_tpu/models/gpr.py:31-114``).

    ``data`` is (X [N, D], Y [N, P]); it is stored as tensors of the default
    float type on ``config.default_device()``."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
        "noise_variance: []",
    )
    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        mean_function: Optional[MeanFunction] = None,
        noise_variance: Optional[Any] = None,
        likelihood: Optional[Gaussian] = None,
    ) -> None:
        if noise_variance is not None and likelihood is not None:
            raise ValueError("Cannot set both `noise_variance` and `likelihood`.")
        if likelihood is None:
            likelihood = Gaussian(1.0 if noise_variance is None else noise_variance)
        _, Y_data = data
        super().__init__(kernel, likelihood, mean_function, num_latent_gps=Y_data.shape[-1])
        self.data = data_input_to_tensor(data)

    def _data_tensors(self) -> RegressionData:
        """(X, Y) as tensors: a GPLVM's X is a Parameter, read as its
        constrained value. Where the rows are split over ranks, the whole
        data: each rank's rows gathered (a GPLVM's X is whole everywhere)."""
        X, Y = self.data
        rows = rows_of(self)
        return (X.value if isinstance(X, Parameter) else rows.gather(X)), rows.gather(Y)

    @check_shapes(
        "return: []",
    )
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.log_marginal_likelihood()

    @check_shapes(
        "return: []",
    )
    def log_marginal_likelihood(self) -> torch.Tensor:
        """log p(Y | theta) through the Cholesky factor of K + sigma^2 I.

        On the INV_SOLVE route the density takes the analytic pullback
        (``ops.linalg.mvn_logp``: dK = 1/2 beta beta^T - 1/2 K^-1, one [N, N]
        matmul and a blocked triangular inverse); otherwise the Cholesky and
        the triangular solve are differentiated by autograd."""
        X, Y = self._data_tensors()
        K = kernel_rows(self, self.kernel, X)
        ks = add_likelihood_noise_cov(K, self.likelihood, X)
        m = self.mean_function(X)
        if _use_inv_solve():
            return torch.sum(mvn_logp(ks, Y - m))
        L = cholesky(ks)
        # [R] log likelihoods, one for each column of Y
        return torch.sum(multivariate_normal(Y, m, L))

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Posterior mean and covariance of f at Xnew, from K(X) + sigma^2 I,
        K(Xnew) and K(X, Xnew) on every call."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)
        X, Y = self._data_tensors()
        err = Y - self.mean_function(X)
        kmm = self.kernel(X)
        knn = self.kernel(Xnew, full_cov=full_cov)
        kmn = self.kernel(X, Xnew)
        kmm_plus_s = add_likelihood_noise_cov(kmm, self.likelihood, X)
        f_mean_zero, f_var = base_conditional(kmn, kmm_plus_s, knn, err, full_cov=full_cov, white=False)
        return f_mean_zero + self.mean_function(Xnew), f_var


class GPR_with_posterior(GPR_deprecated):
    """Adds the cached posterior (``gpflow_tpu/models/gpr.py:117-140``)."""

    def posterior(
        self,
        precompute_cache: posteriors.PrecomputeCacheType = posteriors.PrecomputeCacheType.TENSOR,
    ) -> posteriors.GPRPosterior:
        """The posterior, with its (err, Lm, alpha) cache computed unless
        NOCACHE."""
        return posteriors.GPRPosterior(
            kernel=self.kernel,
            data=self._data_tensors(),
            likelihood=self.likelihood,
            mean_function=self.mean_function,
            precompute_cache=precompute_cache,
        )

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The fused route: K(X) + sigma^2 I, its Cholesky and K(X, Xnew) on
        every call."""
        Xnew = input_to_tensor(self, Xnew)
        return self.posterior(posteriors.PrecomputeCacheType.NOCACHE).fused_predict_f(
            Xnew, full_cov=full_cov, full_output_cov=full_output_cov
        )


class GPR(GPR_with_posterior):
    """Exact Gaussian-process regression with a Gaussian likelihood."""

"""Sparse variational GP (counterpart of ``gpflow_tpu/models/svgp.py``), in
the JAX package's three layers: ``SVGP_deprecated`` (prediction through
``conditionals.conditional``) -> ``SVGP_with_posterior`` (the cached
posterior, and the fused route through it) -> ``SVGP``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import kullback_leiblers, posteriors
from .._sharding import latents_of, rows_of, share_blocks
from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..bijectors import positive, triangular
from ..conditionals import conditional
from ..config import default_float
from ..functions import MeanFunction
from ..kernels import Kernel
from ..likelihoods import Likelihood
from .model import GPModel
from .training_mixins import ExternalDataTrainingLossMixin, RegressionData
from .util import inducingpoint_wrapper
from ..utilities.shapes import check_shapes, inherit_check_shapes

__all__ = ["SVGP", "SVGP_deprecated", "SVGP_with_posterior"]


class SVGP_deprecated(GPModel, ExternalDataTrainingLossMixin):
    """SVGP with the uncollapsed ELBO (``gpflow_tpu/models/svgp.py:33-138``).

    q(u) = N(q_mu, q_sqrt q_sqrt^T), with q_mu [M, L] and q_sqrt [M, L]
    (``q_diag``) or lower triangular [L, M, M]. ``num_data`` is the size N of
    the whole data set, which scales a minibatch's ELBO."""

    @check_shapes(
        "q_mu: [M, P]",
        "q_sqrt: [M, P] if q_diag",
        "q_sqrt: [P, M, M] if (not q_diag)",
    )
    def __init__(
        self,
        kernel: Kernel,
        likelihood: Likelihood,
        inducing_variable: Any,
        *,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: int = 1,
        q_diag: bool = False,
        q_mu: Any = None,
        q_sqrt: Any = None,
        whiten: bool = True,
        num_data: Optional[int] = None,
    ) -> None:
        super().__init__(kernel, likelihood, mean_function, num_latent_gps)
        self.num_data = num_data
        self.whiten = whiten
        self.inducing_variable = inducingpoint_wrapper(inducing_variable)
        self._init_variational_parameters(self.inducing_variable.num_inducing, q_mu, q_sqrt, q_diag)

    @check_shapes(
        "q_mu: [M, P]",
        "q_sqrt: [M, P] if q_diag",
        "q_sqrt: [P, M, M] if (not q_diag)",
    )
    def _init_variational_parameters(self, num_inducing: int, q_mu: Any, q_sqrt: Any, q_diag: bool) -> None:
        dtype = default_float()
        q_mu = np.zeros((num_inducing, self.num_latent_gps)) if q_mu is None else q_mu
        self.q_mu = Parameter(q_mu, dtype=dtype, name="q_mu")  # [M, L]

        if q_sqrt is None:
            if q_diag:
                ones = torch.ones((num_inducing, self.num_latent_gps), dtype=dtype)
                self.q_sqrt = Parameter(ones, transform=positive(), name="q_sqrt")  # [M, L]
            else:
                eye = torch.eye(num_inducing, dtype=dtype).expand(self.num_latent_gps, -1, -1)
                self.q_sqrt = Parameter(eye, transform=triangular(), name="q_sqrt")  # [L, M, M]
        else:
            ndim = len(np.shape(q_sqrt))
            if q_diag:
                if ndim != 2:
                    raise ValueError(f"q_diag needs q_sqrt of shape [M, L], got {np.shape(q_sqrt)}")
                self.num_latent_gps = np.shape(q_sqrt)[1]
                self.q_sqrt = Parameter(q_sqrt, transform=positive(), name="q_sqrt")
            else:
                if ndim != 3:
                    raise ValueError(f"full q_sqrt needs shape [L, M, M], got {np.shape(q_sqrt)}")
                self.num_latent_gps = np.shape(q_sqrt)[0]
                self.q_sqrt = Parameter(q_sqrt, transform=triangular(), name="q_sqrt")

    @check_shapes("return: []")
    def prior_kl(self) -> torch.Tensor:
        return kullback_leiblers.prior_kl(
            self.inducing_variable, self.kernel, self.q_mu.value, self.q_sqrt.value,
            whiten=self.whiten,
        )

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self, data: RegressionData) -> torch.Tensor:
        return self.elbo(data)

    @check_shapes("return: []")
    def elbo(self, data: RegressionData) -> torch.Tensor:
        """ELBO = num_data / B * sum(variational expectations) - KL on a batch
        (X [B, D], Y [B, P]), through ``predict_f``
        (``gpflow_tpu/models/svgp.py:109-122``)."""
        data = input_to_tensor(self, data)
        X, Y = data
        # where the batch rows or the latent GPs are split over ranks (see
        # ``parallel.DataParallelTrainer``): X and Y are this rank's rows, the
        # KL is over this rank's latent GPs, and both sums are all-reduced
        rows = rows_of(self)
        kl = latents_of(self).sum(self.prior_kl())
        f_mean, f_var = self.predict_f(X, full_cov=False, full_output_cov=False)
        var_exp = self.likelihood.variational_expectations(X, f_mean, f_var, Y)
        scale = 1.0 if self.num_data is None else self.num_data / (X.shape[0] * rows.size)
        return rows.sum(torch.sum(var_exp)) * scale - kl

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Through ``conditionals.conditional``: Kuu, its Cholesky and Kuf on
        every call."""
        Xnew = input_to_tensor(self, Xnew)
        mu, var = conditional(
            Xnew,
            self.inducing_variable,
            self.kernel,
            self.q_mu.value,
            q_sqrt=self.q_sqrt.value,
            full_cov=full_cov,
            white=self.whiten,
            full_output_cov=full_output_cov,
        )
        return mu + self.mean_function(Xnew), var


class SVGP_with_posterior(SVGP_deprecated):
    """Adds cached-posterior prediction (``gpflow_tpu/models/svgp.py:141-164``)."""

    def posterior(
        self,
        precompute_cache: posteriors.PrecomputeCacheType = posteriors.PrecomputeCacheType.TENSOR,
    ) -> posteriors.BasePosterior:
        """The posterior, with its (alpha, Qinv) cache computed unless NOCACHE.
        Where the latent GPs are split over ranks, q_mu and q_sqrt are this
        rank's and the posterior conditions those, then gathers."""
        posterior = posteriors.create_posterior(
            self.kernel,
            self.inducing_variable,
            self.q_mu,
            self.q_sqrt,
            whiten=self.whiten,
            mean_function=self.mean_function,
            precompute_cache=None,
        )
        share_blocks(self, posterior)
        if precompute_cache is not None:
            posterior.update_cache(precompute_cache)
        return posterior

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The fused route: Kuu, its Cholesky and Kuf on every call."""
        Xnew = input_to_tensor(self, Xnew)
        return self.posterior(posteriors.PrecomputeCacheType.NOCACHE).fused_predict_f(
            Xnew, full_cov=full_cov, full_output_cov=full_output_cov
        )


class SVGP(SVGP_with_posterior):
    """Sparse Variational Gaussian Process (Hensman et al. 2014)."""

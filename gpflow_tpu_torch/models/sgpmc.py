"""SGPMC: a sparse GP for MCMC over the whitened inducing values (Hensman et
al. 2015; counterpart of ``gpflow_tpu/models/sgpmc.py``).

u = L v, L L^T = Kuu, v ~ N(0, I): V [M, L] is a Parameter with a
Normal(0, 1) prior. The density of V is the variational expectation of the
likelihood under p(f | u) at every data point, through the sparse
``conditional`` (K1 for Kuu and Kuf on a CUDA device where the kernel
routes there, K2 in their backward for the exponential and Matern families).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..conditionals import conditional
from ..config import default_device, default_float
from ..functions import MeanFunction
from ..kernels import Kernel
from ..likelihoods import Likelihood
from ..priors import Normal
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin, RegressionData
from .util import data_input_to_tensor, inducingpoint_wrapper

__all__ = ["SGPMC"]


class SGPMC(GPModel, InternalDataTrainingLossMixin):
    """``gpflow_tpu/models/sgpmc.py:25-84``. ``data`` is (X [N, D], Y [N, P]),
    stored as tensors of the default float type on
    ``config.default_device()``."""

    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        likelihood: Likelihood,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
        inducing_variable: Any = None,
    ) -> None:
        if num_latent_gps is None:
            num_latent_gps = self.calc_num_latent_gps_from_data(data, kernel, likelihood)
        super().__init__(kernel, likelihood, mean_function, num_latent_gps=num_latent_gps)
        self.data = data_input_to_tensor(data)
        self.num_data = self.data[0].shape[0]
        self.inducing_variable = inducingpoint_wrapper(inducing_variable)
        V = torch.zeros(
            (self.inducing_variable.num_inducing, self.num_latent_gps), dtype=default_float(), device=default_device()
        )
        self.V = Parameter(V, prior=Normal(0.0, 1.0), name="V")

    @check_shapes("return: []")
    def log_posterior_density(self) -> torch.Tensor:
        return self.log_likelihood_lower_bound() + self.log_prior_density()

    @check_shapes("return: []")
    def _training_loss(self) -> torch.Tensor:
        return -self.log_posterior_density()

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.log_likelihood_lower_bound()

    @check_shapes("return: []")
    def log_likelihood_lower_bound(self) -> torch.Tensor:
        """The optimal density for V, q*(V), up to a constant (``sgpmc.py:62-68``)."""
        X_data, Y_data = self.data
        fmean, fvar = self.predict_f(X_data, full_cov=False)
        return torch.sum(self.likelihood.variational_expectations(X_data, fmean, fvar, Y_data))

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """p(F* | U = L V) through the sparse ``conditional``, whitened
        (``sgpmc.py:70-84``)."""
        Xnew = input_to_tensor(self, Xnew)
        mu, var = conditional(
            Xnew, self.inducing_variable, self.kernel, self.V.value,
            full_cov=full_cov, q_sqrt=None, white=True, full_output_cov=full_output_cov,
        )
        return mu + self.mean_function(Xnew), var

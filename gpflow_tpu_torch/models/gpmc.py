"""GPMC: a GP with any likelihood for MCMC over the whitened function values
(counterpart of ``gpflow_tpu/models/gpmc.py``).

f = L v + m(X), L L^T = K(X) + jitter I, v ~ N(0, I): V [N, L] is a
Parameter with a Normal(0, 1) prior. On a CUDA device K(X) and K(X, Xnew)
come from kernel K1 where the kernel routes there (and their backward from
K2 for the exponential and Matern families); the [N, N] Cholesky goes to
cuSOLVER, giving NaN where it fails (``ops.linalg.cholesky``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..conditionals import conditional
from ..config import default_device, default_float, default_jitter
from ..functions import MeanFunction
from ..kernels import Kernel
from ..likelihoods import Likelihood
from ..ops.linalg import cholesky
from ..priors import Normal
from ..utilities.model_utils import assert_params_false
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin, RegressionData
from .util import data_input_to_tensor

__all__ = ["GPMC"]


class GPMC(GPModel, InternalDataTrainingLossMixin):
    """``gpflow_tpu/models/gpmc.py:27-84``. ``data`` is (X [N, D], Y [N, P]),
    stored as tensors of the default float type on
    ``config.default_device()``."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
    )
    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        likelihood: Likelihood,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
    ) -> None:
        if num_latent_gps is None:
            num_latent_gps = self.calc_num_latent_gps_from_data(data, kernel, likelihood)
        super().__init__(kernel, likelihood, mean_function, num_latent_gps)
        self.data = data_input_to_tensor(data)
        self.num_data = self.data[0].shape[0]
        V = torch.zeros((self.num_data, self.num_latent_gps), dtype=default_float(), device=default_device())
        self.V = Parameter(V, prior=Normal(0.0, 1.0), name="V")

    @check_shapes("return: []")
    def log_posterior_density(self) -> torch.Tensor:
        return self.log_likelihood() + self.log_prior_density()

    @check_shapes("return: []")
    def _training_loss(self) -> torch.Tensor:
        return -self.log_posterior_density()

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.log_likelihood()

    @check_shapes("return: []")
    def log_likelihood(self) -> torch.Tensor:
        """log p(Y | V, theta) (``gpmc.py:64-74``)."""
        X_data, Y_data = self.data
        K = self.kernel(X_data)
        L = cholesky(K + default_jitter() * torch.eye(self.num_data, dtype=K.dtype, device=K.device))
        F = L @ self.V.value + self.mean_function(X_data)
        return torch.sum(self.likelihood.log_prob(X_data, F, Y_data))

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """p(F* | F = L V) through the dense ``conditional``, whitened
        (``gpmc.py:75-84``)."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)
        X_data, _Y_data = self.data
        mu, var = conditional(Xnew, X_data, self.kernel, self.V.value, full_cov=full_cov, q_sqrt=None, white=True)
        return mu + self.mean_function(Xnew), var

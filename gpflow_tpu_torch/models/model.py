"""Model base classes (counterpart of ``gpflow_tpu/models/model.py``)."""
from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import torch

from ..base import MeanAndVariance, Module, input_to_tensor
from ..conditionals.util import sample_mvn
from ..config import default_device, default_float
from ..functions import MeanFunction, Zero
from ..kernels import Kernel, MultioutputKernel
from ..likelihoods import Likelihood, SwitchedLikelihood
from ..utilities.model_utils import assert_params_false
from ..utilities.shapes import check_shapes

__all__ = ["BayesianModel", "GPModel"]


class BayesianModel(Module, abc.ABC):
    """Base of all models: prior and posterior densities and the objective
    (``gpflow_tpu/models/model.py:22-49``)."""

    @check_shapes("return: []")
    def log_prior_density(self) -> torch.Tensor:
        """Sum of the log prior densities of the trainable parameters
        (``gpflow_tpu/models/model.py:26-34``); a parameter without a prior
        adds 0, so only those with one are evaluated. Without any, a zero of
        the default float type on the device of the model's tensors
        (``config.default_device()`` for a model without any)."""
        densities = [p.log_prior_density() for p in self.trainable_parameters if p.prior is not None]
        if densities:
            return sum(densities[1:], densities[0])
        first = next(self.parameters(), None)
        device = default_device() if first is None else first.device
        return torch.zeros((), dtype=default_float(), device=device)

    @check_shapes(
        "return: []",
    )
    def log_posterior_density(self, *args: Any, **kwargs: Any) -> torch.Tensor:
        return self.maximum_log_likelihood_objective(*args, **kwargs) + self.log_prior_density()

    @check_shapes(
        "return: []",
    )
    def _training_loss(self, *args: Any, **kwargs: Any) -> torch.Tensor:
        """-(objective + log prior density): the loss that training minimises."""
        return -(self.maximum_log_likelihood_objective(*args, **kwargs) + self.log_prior_density())

    @abc.abstractmethod
    @check_shapes(
        "return: []",
    )
    def maximum_log_likelihood_objective(self, *args: Any, **kwargs: Any) -> torch.Tensor:
        raise NotImplementedError


class GPModel(BayesianModel):
    """Base of GP models f ~ GP(m, k), y_i | f_i ~ p(y_i | f_i). Subclasses
    define ``predict_f``; ``predict_y`` and ``predict_log_density`` push it
    through the likelihood."""

    def __init__(
        self,
        kernel: Kernel,
        likelihood: Likelihood,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
    ) -> None:
        super().__init__()
        if num_latent_gps is None:
            raise ValueError("GPModel requires specification of num_latent_gps")
        self.num_latent_gps = num_latent_gps
        self.mean_function = Zero() if mean_function is None else mean_function
        self.kernel = kernel
        self.likelihood = likelihood

    @staticmethod
    @check_shapes(
        "data[0]: [batch..., N, D]",
        "data[1]: [batch..., N, P]",
    )
    def calc_num_latent_gps_from_data(data: Any, kernel: Kernel, likelihood: Likelihood) -> int:
        """The latent GPs for Y's columns (``gpflow_tpu/models/model.py:72-82``):
        see ``calc_num_latent_gps``."""
        _, Y = data
        return GPModel.calc_num_latent_gps(kernel, likelihood, Y.shape[-1])

    @staticmethod
    def calc_num_latent_gps(kernel: Kernel, likelihood: Likelihood, output_dim: int) -> int:
        """A multioutput kernel's own ``num_latent_gps``; else P, or P - 1 for
        a ``SwitchedLikelihood``, whose last column of Y is the index
        (``gpflow_tpu/models/model.py:84-95``)."""
        if isinstance(kernel, MultioutputKernel):
            return kernel.num_latent_gps
        if isinstance(likelihood, SwitchedLikelihood):
            if output_dim < 2:
                raise ValueError("SwitchedLikelihood needs Y with an index column and at least one output")
            return output_dim - 1
        return output_dim

    @abc.abstractmethod
    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
    )
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        raise NotImplementedError

    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return: [batch..., S, N, P] if num_samples is not None",
        "return: [batch..., N, P] if num_samples is None",
    )
    def predict_f_samples(
        self,
        Xnew: torch.Tensor,
        num_samples: Optional[int] = None,
        full_cov: bool = True,
        full_output_cov: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Draws from the posterior of the latent functions at Xnew
        (``gpflow_tpu/models/model.py:110-137``), through ``sample_mvn`` with
        ``generator``."""
        Xnew = input_to_tensor(self, Xnew)
        if full_cov and full_output_cov:
            raise NotImplementedError(
                "The combination of both `full_cov` and `full_output_cov` is not supported."
            )
        mean, cov = self.predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        if full_cov:
            # mean [..., N, P] as [..., P, N] against cov [..., P, N, N]
            return sample_mvn(mean.mT, cov, True, num_samples=num_samples, generator=generator).mT
        return sample_mvn(mean, cov, full_output_cov, num_samples=num_samples, generator=generator)

    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P]",
    )
    def predict_y(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Mean and variance of held-out data at Xnew."""
        Xnew = input_to_tensor(self, Xnew)
        if full_cov or full_output_cov:
            raise NotImplementedError(
                f"{type(self).__name__}.predict_y does not currently support: "
                f"full_cov={full_cov}, full_output_cov={full_output_cov}"
            )
        f_mean, f_var = self.predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        return self.likelihood.predict_mean_and_var(Xnew, f_mean, f_var)

    @check_shapes(
        "return: [batch..., N]",
    )
    def predict_log_density(
        self, data: Tuple[torch.Tensor, torch.Tensor], full_cov: bool = False, full_output_cov: bool = False
    ) -> torch.Tensor:
        """log p(Y | X) of held-out data (X [N, D], Y [N, P]) -> [N]
        (``gpflow_tpu/models/model.py:155-164``)."""
        data = input_to_tensor(self, data)
        assert_params_false(self.predict_log_density, full_cov=full_cov, full_output_cov=full_output_cov)
        X, Y = data
        f_mean, f_var = self.predict_f(X, full_cov=full_cov, full_output_cov=full_output_cov)
        return self.likelihood.predict_log_density(X, f_mean, f_var, Y)

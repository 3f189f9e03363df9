"""Model base class (counterpart of ``gpflow_tpu/models/model.py``; the
prediction part of ``GPModel``)."""
from __future__ import annotations

import abc
from typing import Optional

import torch

from ..base import MeanAndVariance, Module
from ..functions import MeanFunction, Zero
from ..kernels import Kernel
from ..likelihoods import Likelihood

__all__ = ["GPModel"]


class GPModel(Module, abc.ABC):
    """Base of GP models f ~ GP(m, k), y_i | f_i ~ p(y_i | f_i). Subclasses
    define ``predict_f``; ``predict_y`` pushes it through the likelihood."""

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

    @abc.abstractmethod
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        raise NotImplementedError

    def predict_y(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Mean and variance of held-out data at Xnew."""
        if full_cov or full_output_cov:
            raise NotImplementedError(
                f"{type(self).__name__}.predict_y does not currently support: "
                f"full_cov={full_cov}, full_output_cov={full_output_cov}"
            )
        f_mean, f_var = self.predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        return self.likelihood.predict_mean_and_var(Xnew, f_mean, f_var)

"""The GPLVM and the Bayesian GPLVM (counterpart of ``gpflow_tpu/models/gplvm.py``).

``GPLVM`` is a GPR whose inputs X are a trainable Parameter, started from
PCA; on a CUDA device its [N, N] K(X) comes from kernel K1 and, for the
exponential and Matern kernels, its gradient from K2. ``BayesianGPLVM``
(Titsias and Lawrence 2010) bounds the marginal likelihood under a diagonal
Gaussian q(X) through the psi statistics of ``expectations``; its Kuu and the
Kuf of ``predict_f`` come from K1. The SquaredExponential psi2 is formed as
[N, M, M] and summed over N."""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from .. import kernels as kernels_module
from .._sharding import rows_of
from ..base import InputData, MeanAndVariance, Module, OutputData, Parameter, RegressionData, input_to_tensor
from ..bijectors import positive
from ..config import default_float, default_jitter
from ..covariances import Kuf, Kuu
from ..expectations import expectation
from ..functions import MeanFunction, Zero
from ..inducing_variables import InducingPoints
from ..kernels import Kernel
from ..likelihoods import Gaussian
from ..ops.linalg import cholesky
from ..probability_distributions import DiagonalGaussian
from ..utilities.model_utils import assert_params_false
from ..utilities.ops import pca_reduce
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .gpr import GPR
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin
from .util import data_input_to_tensor, inducingpoint_wrapper

__all__ = ["BayesianGPLVM", "GPLVM"]


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def _psi2_projection(L: torch.Tensor, psi2: torch.Tensor) -> torch.Tensor:
    """L^-1 psi2 L^-T (``gplvm.py:33-60``).

    In float64 this is the two triangular solves. Below float64 their result
    is not positive semi-definite under rounding (psi2 rounds indefinite at
    ~eps lambda_max and the solves amplify that by cond(Kuu)), and the
    Cholesky of AAT + I then gives NaN. So the value comes from psi2's
    eigenvalues clipped at 0 (a Gram factor, positive semi-definite by
    construction), and the gradient flows through the solves, as in the JAX
    package. ``torch.linalg.eigh`` checks its errors on the host: one sync
    per call on a CUDA device."""
    aat = _solve_lower(L, _solve_lower(L, psi2).mT)
    if L.dtype == torch.float64:
        return aat
    with torch.no_grad():
        w, V = torch.linalg.eigh(0.5 * (psi2 + psi2.mT))
        C = _solve_lower(L, V * torch.sqrt(torch.clamp(w, min=0.0)))
        correction = C @ C.mT - aat
    return aat + correction


class _LatentData(Module):
    """A GPLVM's data (X, Y), read as a tuple: ``data[0]`` is the latent X,
    a Parameter registered here as the submodule ``0`` (so that its path is
    ``.data[0]``, as the JAX package's ``read_values`` writes it), and
    ``data[1]`` the observed Y, a buffer."""

    def __init__(self, X: Parameter, Y: torch.Tensor) -> None:
        super().__init__()
        self.add_module("0", X)
        self.register_buffer("1", Y)

    def __getitem__(self, index: int) -> Any:
        return (self._modules["0"], self._buffers["1"])[index]

    def __iter__(self):
        return iter((self[0], self[1]))

    def __len__(self) -> int:
        return 2


class GPLVM(GPR):
    """The GPLVM (Lawrence 2005): GPR whose inputs are the trainable latent
    X [N, Q], by default the PCA projection of the data Y [N, P]
    (``gplvm.py:63-96``)."""

    @check_shapes(
        "data: [N, P]",
        "X_data_mean: [N, Q]",
    )
    def __init__(
        self,
        data: OutputData,
        latent_dim: int,
        X_data_mean: Optional[Any] = None,
        kernel: Optional[Kernel] = None,
        mean_function: Optional[MeanFunction] = None,
    ) -> None:
        Y = data_input_to_tensor(data)
        if X_data_mean is None:
            X_data_mean = pca_reduce(Y, latent_dim)

        num_latent_gps = X_data_mean.shape[1]
        if num_latent_gps != latent_dim:
            raise ValueError(
                f"Passed in number of latent {latent_dim} does not match initial X {num_latent_gps}."
            )

        if mean_function is None:
            mean_function = Zero()
        if kernel is None:
            kernel = kernels_module.SquaredExponential(lengthscales=[1.0] * latent_dim)
        if Y.shape[1] < num_latent_gps:
            raise ValueError("More latent dimensions than observed.")

        X = Parameter(X_data_mean, name="X_data_mean")
        super().__init__((X, Y), kernel, mean_function=mean_function)
        self.data = _LatentData(X, Y)


class BayesianGPLVM(GPModel, InternalDataTrainingLossMixin):
    """The Bayesian GPLVM with a diagonal Gaussian q(X) = N(X_data_mean,
    X_data_var) over X [N, Q] and the prior N(X_prior_mean, X_prior_var)
    (``gplvm.py:99-270``). The bound is the collapsed SGPR bound with the
    psi statistics in place of Kff, Kuf and Kuf Kfu, minus KL[q(X) || p(X)].
    Z is ``inducing_variable`` or, given ``num_inducing_variables``, that
    many rows of X_data_mean picked by numpy's global generator, as the JAX
    package picks them."""

    @check_shapes(
        "data: [N, P]",
        "X_data_mean: [N, Q]",
        "X_data_var: [N, Q]",
        "X_prior_mean: [N, Q]",
        "X_prior_var: [N, Q]",
    )
    def __init__(
        self,
        data: OutputData,
        X_data_mean: Any,
        X_data_var: Any,
        kernel: Kernel,
        num_inducing_variables: Optional[int] = None,
        inducing_variable: Any = None,
        X_prior_mean: Optional[Any] = None,
        X_prior_var: Optional[Any] = None,
    ) -> None:
        num_data, num_latent_gps = X_data_mean.shape
        super().__init__(kernel, Gaussian(), num_latent_gps=num_latent_gps)
        self.data = data_input_to_tensor(data)

        self.X_data_mean = Parameter(X_data_mean, name="X_data_mean")
        self.X_data_var = Parameter(X_data_var, transform=positive(), name="X_data_var")

        self.num_data = num_data
        self.output_dim = self.data.shape[-1]

        if (inducing_variable is None) == (num_inducing_variables is None):
            raise ValueError(
                "BayesianGPLVM needs exactly one of `inducing_variable` and `num_inducing_variables`"
            )

        if inducing_variable is None:
            # a random subset of the initial latent points
            perm = np.random.permutation(num_data)[:num_inducing_variables]
            inducing_variable = InducingPoints(self.X_data_mean.numpy()[perm])

        self.inducing_variable = inducingpoint_wrapper(inducing_variable)

        device = self.X_data_mean.device
        if X_prior_mean is None:
            X_prior_mean = np.zeros((self.num_data, self.num_latent_gps))
        if X_prior_var is None:
            X_prior_var = np.ones((self.num_data, self.num_latent_gps))
        # [N, Q], as the contract says: a [Q] prior would broadcast, and the
        # KL's sum of log(X_prior_var) would silently lose a factor of N
        expected = (self.num_data, self.num_latent_gps)
        for name, value in (("X_prior_mean", X_prior_mean), ("X_prior_var", X_prior_var)):
            value = torch.as_tensor(np.atleast_1d(np.asarray(value)), dtype=default_float(), device=device)
            if tuple(value.shape) != expected:
                raise ValueError(
                    f"{name} must have shape [num_data, num_latent_gps] = {expected}, got {tuple(value.shape)}"
                )
            self.register_buffer(name, value)

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.elbo()

    def _psi_statistics(self, pX: DiagonalGaussian) -> tuple:
        """psi1 [N, M] and psi2 summed over N [M, M]."""
        kernel_and_iv = (self.kernel, self.inducing_variable)
        psi1 = expectation(pX, kernel_and_iv)
        psi2 = rows_of(self).sum(torch.sum(expectation(pX, kernel_and_iv, kernel_and_iv), dim=0))
        return psi1, psi2

    def _q_x(self) -> DiagonalGaussian:
        """q(X) over this rank's rows (all rows where they are not split)."""
        rows = rows_of(self)
        return DiagonalGaussian(rows.local(self.X_data_mean.value), rows.local(self.X_data_var.value))

    @check_shapes("return: []")
    def elbo(self) -> torch.Tensor:
        """The collapsed bound with the psi statistics, minus the KL of
        q(X) from the prior (``gplvm.py:174-221``)."""
        Y_data = self.data
        rows = rows_of(self)

        pX = self._q_x()

        num_inducing = self.inducing_variable.num_inducing
        psi0 = rows.sum(torch.sum(expectation(pX, self.kernel)))
        psi1, psi2 = self._psi_statistics(pX)
        L = cholesky(Kuu(self.inducing_variable, self.kernel, jitter=default_jitter()))
        sigma2 = self.likelihood.variance.value

        A = _solve_lower(L, psi1.mT)
        AAT = _psi2_projection(L, psi2) / sigma2
        B = AAT + torch.eye(num_inducing, dtype=AAT.dtype, device=AAT.device)
        LB = cholesky(B)
        log_det_B = 2.0 * torch.sum(torch.log(torch.diagonal(LB)))
        c = _solve_lower(LB, rows.sum(A @ Y_data)) / sigma2

        # KL[q(x) || p(x)]
        dX_data_var = self.X_data_var.value
        NQ = float(self.X_data_mean.value.numel())
        D = float(Y_data.shape[1])
        KL = -0.5 * torch.sum(torch.log(dX_data_var))
        KL = KL + 0.5 * torch.sum(torch.log(self.X_prior_var))
        KL = KL - 0.5 * NQ
        KL = KL + 0.5 * torch.sum(
            (torch.square(self.X_data_mean.value - self.X_prior_mean) + dX_data_var) / self.X_prior_var
        )

        ND = float(Y_data.numel() * rows.size)
        bound = -0.5 * ND * torch.log(2 * math.pi * sigma2)
        bound = bound - 0.5 * D * log_det_B
        bound = bound - 0.5 * rows.sum(torch.sum(torch.square(Y_data))) / sigma2
        bound = bound + 0.5 * torch.sum(torch.square(c))
        bound = bound - 0.5 * D * (psi0 / sigma2 - torch.sum(torch.diagonal(AAT)))
        return bound - KL

    @inherit_check_shapes
    def predict_f(
        self, Xnew: InputData, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The SGPR prediction with the psi statistics in place of Kuf and
        Kuf Kfu (``gplvm.py:223-265``): mean [N, P], variance [N, P] or,
        with ``full_cov``, [P, N, N]."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)

        pX = self._q_x()

        Y_data = self.data
        num_inducing = self.inducing_variable.num_inducing
        psi1, psi2 = self._psi_statistics(pX)
        Kus = Kuf(self.inducing_variable, self.kernel, Xnew)
        sigma2 = self.likelihood.variance.value
        L = cholesky(Kuu(self.inducing_variable, self.kernel, jitter=default_jitter()))

        A = _solve_lower(L, psi1.mT)
        AAT = _psi2_projection(L, psi2) / sigma2
        B = AAT + torch.eye(num_inducing, dtype=AAT.dtype, device=AAT.device)
        LB = cholesky(B)
        c = _solve_lower(LB, rows_of(self).sum(A @ Y_data)) / sigma2
        tmp1 = _solve_lower(L, Kus)
        tmp2 = _solve_lower(LB, tmp1)
        mean = tmp2.mT @ c
        P = Y_data.shape[1]
        if full_cov:
            var = self.kernel(Xnew) + tmp2.mT @ tmp2 - tmp1.mT @ tmp1
            var = var[None].expand((P,) + var.shape)
        else:
            var = (
                self.kernel(Xnew, full_cov=False)
                + torch.sum(torch.square(tmp2), dim=0)
                - torch.sum(torch.square(tmp1), dim=0)
            )
            var = var[:, None].expand(var.shape + (P,))
        return mean + self.mean_function(Xnew), var

    @inherit_check_shapes
    def predict_log_density(
        self, data: RegressionData, full_cov: bool = False, full_output_cov: bool = False
    ) -> torch.Tensor:
        raise NotImplementedError

"""Likelihood base classes (counterpart of ``gpflow_tpu/likelihoods/base.py``):
``Likelihood``, the Gauss-Hermite fallback ``QuadratureLikelihood``,
``ScalarLikelihood``, ``SwitchedLikelihood`` and the Monte-Carlo fallback
``MonteCarloLikelihood``.

Shapes: the last dimension of F holds the latent functions and of Y the
observations; every statistic returns the batch shape with it reduced.

``SwitchedLikelihood`` evaluates every sub-likelihood on the whole batch and
selects per row with a mask, as the JAX package does: no shape depends on
the data, and no step reads the index column on the host.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Union

import torch
from torch import nn

from ..base import MeanAndVariance, Module, input_to_tensor
from ..config import default_device
from ..quadrature import GaussianQuadrature, NDiagGHQuadrature, ndiag_mc
from ..quadrature.gauss_hermite import canonical_device
from ..utilities.shapes import check_shapes, inherit_check_shapes

__all__ = [
    "DEFAULT_NUM_GAUSS_HERMITE_POINTS",
    "Likelihood",
    "MonteCarloLikelihood",
    "QuadratureLikelihood",
    "ScalarLikelihood",
    "SwitchedLikelihood",
]

DEFAULT_NUM_GAUSS_HERMITE_POINTS = 20
"""The Gauss-Hermite resolution of the quadrature fallback (``base.py:33``)."""


class Likelihood(Module, abc.ABC):
    """Observation model p(Y | X, F) (``base.py:37-168``)."""

    def __init__(
        self,
        input_dim: Optional[int],
        latent_dim: Optional[int],
        observation_dim: Optional[int],
    ) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.latent_dim = latent_dim
        self.observation_dim = observation_dim

    @check_shapes(
        "F: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(Y | X, F) -> [batch...]."""
        X, F, Y = input_to_tensor(self, (X, F, Y))
        return self._log_prob(X, F, Y)

    @abc.abstractmethod
    @check_shapes(
        "F: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        """E[Y | X, F] -> [batch..., observation_dim]."""
        X, F = input_to_tensor(self, (X, F))
        return self._conditional_mean(X, F)

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        """var[Y | X, F] -> [batch..., observation_dim]."""
        X, F = input_to_tensor(self, (X, F))
        return self._conditional_variance(X, F)

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "return[0]: [batch..., R]",
        "return[1]: [batch..., R]",
    )
    def predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        """Mean and variance of Y under q(f) = N(Fmu, Fvar)."""
        X, Fmu, Fvar = input_to_tensor(self, (X, Fmu, Fvar))
        return self._predict_mean_and_var(X, Fmu, Fvar)

    @abc.abstractmethod
    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "return[0]: [batch..., R]",
        "return[1]: [batch..., R]",
    )
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        raise NotImplementedError

    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        """log int p(Y | f) q(f) df -> [batch...]."""
        X, Fmu, Fvar, Y = input_to_tensor(self, (X, Fmu, Fvar, Y))
        return self._predict_log_density(X, Fmu, Fvar, Y)

    @abc.abstractmethod
    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        """int log p(Y | f) q(f) df -> [batch...] (``base.py:152-168``)."""
        X, Fmu, Fvar, Y = input_to_tensor(self, (X, Fmu, Fvar, Y))
        return self._variational_expectations(X, Fmu, Fvar, Y)

    @abc.abstractmethod
    @check_shapes(
        "Fmu: [batch..., Q]",
        "Fvar: [batch..., Q]",
        "Y: [batch_y..., R]",
        "return: [batch...]",
    )
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError


class QuadratureLikelihood(Likelihood, abc.ABC):
    """Gauss-Hermite quadrature as the fallback for the three Gaussian
    integrals (``base.py:171-241``); ``quadrature`` defaults to
    ``DEFAULT_NUM_GAUSS_HERMITE_POINTS`` points per dimension."""

    def __init__(
        self,
        input_dim: Optional[int],
        latent_dim: Optional[int],
        observation_dim: Optional[int],
        *,
        quadrature: Optional[GaussianQuadrature] = None,
    ) -> None:
        super().__init__(input_dim=input_dim, latent_dim=latent_dim, observation_dim=observation_dim)
        if quadrature is None:
            quadrature = NDiagGHQuadrature(self._quadrature_dim, DEFAULT_NUM_GAUSS_HERMITE_POINTS)
        self.quadrature = quadrature

    @property
    def _quadrature_dim(self) -> int:
        assert self.latent_dim is not None
        return self.latent_dim

    @check_shapes(
        "F: [broadcast batch..., latent_dim]",
        "X: [broadcast batch..., input_dim]",
        "Y: [broadcast batch..., observation_dim]",
        "return: [batch..., d]",
    )
    def _quadrature_log_prob(self, F: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """The integrand [batch..., d'] with d' = 1."""
        return self.log_prob(X, F, Y)[..., None]

    @check_shapes(
        "quadrature_result: [batch..., d]",
        "return: [batch...]",
    )
    def _quadrature_reduction(self, quadrature_result: torch.Tensor) -> torch.Tensor:
        return quadrature_result.squeeze(-1)

    @inherit_check_shapes
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._quadrature_reduction(
            self.quadrature.logspace(self._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y)
        )

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._quadrature_reduction(self.quadrature(self._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y))

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        def conditional_mean(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_mean(X_, F)

        def conditional_y_squared(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_variance(X_, F) + torch.square(self.conditional_mean(X_, F))

        E_y, E_y2 = self.quadrature([conditional_mean, conditional_y_squared], Fmu, Fvar, X_=X)
        return E_y, E_y2 - E_y ** 2


class ScalarLikelihood(QuadratureLikelihood, abc.ABC):
    """Likelihoods that act on each scalar latent independently: implement
    ``_scalar_log_prob``; ``log_prob`` sums it over the last axis, and the
    quadrature is one-dimensional, broadcast over the latents
    (``base.py:244-286``)."""

    #: an observation with a finite log density under every built-in scalar
    #: likelihood (what ``SwitchedLikelihood`` substitutes for other rows)
    safe_observation: float = 0.5

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(input_dim=None, latent_dim=None, observation_dim=None, **kwargs)

    @inherit_check_shapes
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._scalar_log_prob(X, F, Y), dim=-1)

    @abc.abstractmethod
    @check_shapes(
        "X: [broadcast batch..., N, D]",
        "F: [broadcast batch..., N, P]",
        "Y: [broadcast batch..., N, Q]",
        "return: [batch..., N, P]",
    )
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(y | x, f) per scalar -> [batch..., N, P]."""
        raise NotImplementedError

    @property
    def _quadrature_dim(self) -> int:
        return 1

    @inherit_check_shapes
    def _quadrature_log_prob(self, F: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self._scalar_log_prob(X, F, Y)

    @inherit_check_shapes
    def _quadrature_reduction(self, quadrature_result: torch.Tensor) -> torch.Tensor:
        return torch.sum(quadrature_result, dim=-1)


class SwitchedLikelihood(ScalarLikelihood):
    """A likelihood per row: the last column of Y holds the index of the
    likelihood in ``likelihood_list`` that scores the row
    (``base.py:289-380``).

    Each sub-likelihood is evaluated on the whole batch, with the
    observations of the rows it does not own replaced by its
    ``safe_observation`` (finite under every built-in likelihood), and each
    row keeps the result of its own likelihood: out-of-support observations
    under the other likelihoods reach neither the values nor the gradients.
    A row whose index lies outside [0, K) gives NaN, so a bad label shows in
    the loss instead of scoring log-probability 0."""

    def __init__(self, likelihood_list: Iterable[ScalarLikelihood], **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.likelihoods = nn.ModuleList(likelihood_list)

    @check_shapes(
        "args[all]: [batch..., .]",
    )
    def _masked_apply(self, args: Sequence[torch.Tensor], func_name: str) -> torch.Tensor:
        *inputs, Y = args
        ind = Y[..., -1].to(torch.int64)  # [batch...]
        Ydata = Y[..., :-1]
        results = []
        for k, lik in enumerate(self.likelihoods):
            selected = (ind == k)[..., None]  # [batch..., 1]
            Y_safe = torch.where(selected, Ydata, getattr(lik, "safe_observation", 0.5))
            results.append(getattr(lik, func_name)(*inputs, Y_safe))
        stacked = torch.stack(results, dim=0)  # [K, batch..., (latent)]
        K = len(self.likelihoods)
        mask = ind[None] == torch.arange(K, device=ind.device).reshape((-1,) + (1,) * ind.ndim)
        mask = mask.reshape(mask.shape + (1,) * (stacked.ndim - mask.ndim))
        out = torch.sum(torch.where(mask, stacked, 0.0), dim=0)
        valid = (ind >= 0) & (ind < K)
        valid = valid.reshape(valid.shape + (1,) * (out.ndim - valid.ndim))
        return torch.where(valid, out, torch.nan)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self._masked_apply([X, F, Y], "_scalar_log_prob")

    @inherit_check_shapes
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._masked_apply([X, Fmu, Fvar, Y], "predict_log_density")

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._masked_apply([X, Fmu, Fvar, Y], "variational_expectations")

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        mvs = [lik.predict_mean_and_var(X, Fmu, Fvar) for lik in self.likelihoods]
        mu_list, var_list = zip(*mvs)
        return torch.cat(mu_list, dim=1), torch.cat(var_list, dim=1)

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "F: [batch..., Q]",
        "return: [batch..., R]",
    )
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class MonteCarloLikelihood(Likelihood):
    """The Monte-Carlo fallback for the three Gaussian integrals, from
    ``num_monte_carlo_points`` = 100 draws per point (``base.py:382-456``).

    Each private statistic takes ``epsilon`` [S, N, latent_dim], the
    standard normals to use. Without one, the draws come from this
    likelihood's own ``torch.Generator`` on the tensors' device, seeded with
    ``seed`` (default 0) when made; ``generator`` gives the likelihood the
    caller's generator instead. A draw queues on the device and never waits
    for it."""

    def __init__(
        self, *args: Any, seed: int = 0, generator: Optional[torch.Generator] = None, **kwargs: Any
    ) -> None:
        super().__init__(*args, **kwargs)
        self.num_monte_carlo_points = 100
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}
        if generator is not None:
            self._generators[canonical_device(generator.device)] = generator
        else:
            self.generator(default_device())

    def generator(self, device: Union[str, torch.device]) -> torch.Generator:
        """The generator of the draws on ``device``: the caller's, or one
        seeded with ``seed`` when first needed there."""
        key = canonical_device(device)
        if key not in self._generators:
            self._generators[key] = torch.Generator(device=key).manual_seed(self.seed)
        return self._generators[key]

    @check_shapes(
        "Fmu: [batch..., latent_dim]",
        "Fvar: [batch..., latent_dim]",
        "Ys.values(): [batch..., .]",
        "return: [broadcast n_funcs, batch..., .]",
    )
    def _mc_quadrature(
        self,
        funcs: Union[Callable[..., torch.Tensor], Iterable[Callable[..., torch.Tensor]]],
        Fmu: torch.Tensor,
        Fvar: torch.Tensor,
        logspace: bool = False,
        epsilon: Optional[torch.Tensor] = None,
        **Ys: torch.Tensor,
    ) -> Any:
        generator = None if epsilon is not None else self.generator(Fmu.device)
        return ndiag_mc(funcs, self.num_monte_carlo_points, Fmu, Fvar, logspace, epsilon,
                        generator=generator, **Ys)

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, epsilon: Optional[torch.Tensor] = None
    ) -> MeanAndVariance:
        def conditional_mean(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_mean(X_, F)

        def conditional_y_squared(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_variance(X_, F) + torch.square(self.conditional_mean(X_, F))

        E_y, E_y2 = self._mc_quadrature([conditional_mean, conditional_y_squared], Fmu, Fvar, epsilon=epsilon, X_=X)
        return E_y, E_y2 - torch.square(E_y)

    @inherit_check_shapes
    def _predict_log_density(
        self,
        X: torch.Tensor,
        Fmu: torch.Tensor,
        Fvar: torch.Tensor,
        Y: torch.Tensor,
        epsilon: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        def log_prob(F: torch.Tensor, X_: torch.Tensor, Y_: torch.Tensor) -> torch.Tensor:
            return self.log_prob(X_, F, Y_)

        return torch.sum(
            self._mc_quadrature(log_prob, Fmu, Fvar, logspace=True, epsilon=epsilon, X_=X, Y_=Y), dim=-1
        )

    @inherit_check_shapes
    def _variational_expectations(
        self,
        X: torch.Tensor,
        Fmu: torch.Tensor,
        Fvar: torch.Tensor,
        Y: torch.Tensor,
        epsilon: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        def log_prob(F: torch.Tensor, X_: torch.Tensor, Y_: torch.Tensor) -> torch.Tensor:
            return self.log_prob(X_, F, Y_)

        return torch.sum(self._mc_quadrature(log_prob, Fmu, Fvar, epsilon=epsilon, X_=X, Y_=Y), dim=-1)

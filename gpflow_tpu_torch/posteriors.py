"""Posteriors with a precomputed prediction cache (counterpart of
``gpflow_tpu/posteriors.py``; the single-output base case, the exact-GP,
the SGPR and the VGP posteriors so far).

``BasePosterior`` caches (alpha, Qinv), after which a prediction is matmuls
only: mean = Kuf^T alpha, var = Kff - Kuf^T Qinv Kuf. The cache stores an
explicit inverse, so its float32 variance carries an error of about
cond(Kuu)^2 * eps; the fused route (``fused_predict_f``, Cholesky per call)
carries about cond(Kuu) * eps. ``GPRPosterior`` caches (err, Lm, alpha) of
the training data: a request solves against Lm, and ``predict_mean`` is one
matvec. ``SGPRPosterior`` caches (L, LB, c, alpha) of the sparse regression:
a request solves against the two [M, M] factors, and ``predict_mean`` is
K(Z, Xnew) and one matvec. ``VGPPosterior`` caches Lm = chol(K(X) +
jitter I) of the data: a request builds K(X, Xnew) and solves against Lm.

The multioutput posteriors keep the same (alpha, Qinv) cache, per latent
GP where Kuu is [L, M, M] (alpha [L, M, 1]) and over the flattened [MP]
vector where it is the fully correlated [M, P, M, P].
``IndependentPosteriorMultiOutput`` conditions each output (or latent GP)
on its own Kuu and Kuf, ``LinearCoregionalizationPosterior`` then mixes the
latent GPs with W, ``FullyCorrelatedPosterior`` conditions all outputs
jointly, and ``FallbackIndependentLatentPosterior`` goes through the
interdomain Kuf [M, L, N, P].

On CUDA, every covariance matrix of a stationary kernel comes from kernel
K1 (``ops/pallas_distance.py``).
"""
from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Optional, Tuple, Type, Union

import torch

from . import kernels
from ._sharding import WHOLE, latents_of, rows_of
from .base import MeanAndVariance, Module, Parameter, input_to_tensor
from .conditionals.util import (
    base_conditional,
    base_conditional_with_lm,
    expand_independent_outputs,
    fully_correlated_conditional,
    independent_interdomain_conditional,
    mix_latent_gp,
    separate_independent_conditional_implementation,
)
from .config import default_jitter
from .covariances import Kuf, Kuu
from .functions import MeanFunction
from .inducing_variables import (
    FallbackSeparateIndependentInducingVariables,
    FallbackSharedIndependentInducingVariables,
    InducingPoints,
    InducingVariables,
    SeparateIndependentInducingVariables,
    SharedIndependentInducingVariables,
)
from .likelihoods import Gaussian
from .ops.linalg import cholesky
from .utilities.model_utils import add_likelihood_noise_cov, assert_params_false
from .utilities.multipledispatch import Dispatcher
from .utilities.shapes import check_shapes, inherit_check_shapes, register_get_shape

__all__ = [
    "AbstractPosterior",
    "BasePosterior",
    "FallbackIndependentLatentPosterior",
    "FullyCorrelatedPosterior",
    "GPRPosterior",
    "IndependentPosterior",
    "IndependentPosteriorMultiOutput",
    "IndependentPosteriorSingleOutput",
    "LinearCoregionalizationPosterior",
    "PrecomputeCacheType",
    "PrecomputedValue",
    "SGPRPosterior",
    "VGPPosterior",
    "create_posterior",
    "get_posterior_class",
    "get_precomputed_value_shape",
]


def _value(x: Any) -> Optional[torch.Tensor]:
    return x.value if isinstance(x, Parameter) else x


class _QDistribution(Module):
    """q(u)'s parametrisation (``gpflow_tpu/posteriors.py:88-121``): a
    Parameter stays a Parameter, so the posterior reads its live value."""


class _DeltaDist(_QDistribution):
    @check_shapes(
        "q_mu: [M, L]",
    )
    def __init__(self, q_mu: Any) -> None:
        super().__init__()
        self.q_mu = q_mu

    @property
    def q_sqrt(self) -> None:
        return None


class _DiagNormal(_QDistribution):
    @check_shapes(
        "q_mu: [M, L]",
        "q_sqrt: [M, L]",
    )
    def __init__(self, q_mu: Any, q_sqrt: Any) -> None:
        super().__init__()
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt


class _MvNormal(_QDistribution):
    @check_shapes(
        "q_mu: [M, L]",
        "q_sqrt: [L, M, M]",
    )
    def __init__(self, q_mu: Any, q_sqrt: Any) -> None:
        super().__init__()
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt


class PrecomputeCacheType(enum.Enum):
    """TENSOR precomputes the cache into tensors; VARIABLE is accepted for the
    JAX package's API and behaves as TENSOR (``posteriors.py:105-113``);
    NOCACHE skips it."""

    TENSOR = "tensor"
    VARIABLE = "variable"
    NOCACHE = "nocache"


@dataclass
class PrecomputedValue:
    """A cache entry and, per axis, whether it may change size between
    calls (``gpflow_tpu/posteriors.py:135-161``); informational, as torch
    runs each shape eagerly."""

    value: torch.Tensor
    axis_dynamic: Tuple[bool, ...]

    @staticmethod
    def shape_of(value: "PrecomputedValue") -> Tuple[Optional[int], ...]:
        """The shape, with each dynamic axis as None (unknown)."""
        return tuple(None if dyn else int(s) for s, dyn in zip(value.value.shape, value.axis_dynamic))

    @staticmethod
    @check_shapes(
        "alpha: [M, L] | [L, M, 1]",
        "Qinv: [M, M] | [L, M, M]",
    )
    def wrap_alpha_Qinv(alpha: torch.Tensor, Qinv: torch.Tensor) -> Tuple["PrecomputedValue", ...]:
        """(alpha, Qinv) of ``BasePosterior``'s cache, every axis fixed."""
        return (
            PrecomputedValue(alpha, (False,) * alpha.ndim),
            PrecomputedValue(Qinv, (False,) * Qinv.ndim),
        )


@register_get_shape(PrecomputedValue)
def get_precomputed_value_shape(shaped: PrecomputedValue) -> Tuple[Optional[int], ...]:
    """The shape that shape contracts see (``gpflow_tpu/posteriors.py:164-170``):
    dynamic axes are unknown."""
    return PrecomputedValue.shape_of(shaped)


def _validate_precompute_cache_type(value: Union[None, PrecomputeCacheType, str]) -> PrecomputeCacheType:
    if value is None:
        return PrecomputeCacheType.NOCACHE
    if isinstance(value, PrecomputeCacheType):
        return value
    if isinstance(value, str):
        return PrecomputeCacheType(value.lower())
    raise ValueError(
        f"{value} is not a valid PrecomputeCacheType. Valid options: 'tensor', 'variable', 'nocache' (or None)."
    )


class AbstractPosterior(Module, ABC):
    """Fused (no cache) and cached prediction."""

    @check_shapes(
        "X_data: [N, D] | [M, D, broadcast P]",
    )
    def __init__(
        self,
        kernel: kernels.Kernel,
        X_data: InducingVariables,
        cache: Optional[Tuple[torch.Tensor, ...]] = None,
        mean_function: Optional[MeanFunction] = None,
    ) -> None:
        super().__init__()
        self.kernel = kernel
        self.X_data = input_to_tensor(kernel, X_data)
        self.cache = cache
        self.mean_function = mean_function
        self._precompute_cache: Optional[PrecomputeCacheType] = None

    @check_shapes(
        "Xnew: [batch..., D]",
        "mean: [batch..., Q]",
        "return: [batch..., Q]",
    )
    def _add_mean_function(self, Xnew: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        if self.mean_function is None:
            return mean
        return mean + self.mean_function(Xnew)

    @abstractmethod
    def _precompute(self) -> Tuple[torch.Tensor, ...]:
        """Computes the cache that _conditional_with_precompute consumes."""

    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
    )
    def fused_predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Mean and covariance at Xnew, mean function included, without the cache."""
        Xnew = input_to_tensor(self, Xnew)
        mean, cov = self._conditional_fused(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        return self._add_mean_function(Xnew, mean), cov

    @abstractmethod
    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
    )
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """Mean and covariance at Xnew, without mean function or cache."""

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
        """Mean and covariance at Xnew, mean function included, from the cache."""
        Xnew = input_to_tensor(self, Xnew)
        if self.cache is None:
            raise ValueError(
                "Cache has not been precomputed yet. Call update_cache first or use fused_predict_f"
            )
        mean, cov = self._conditional_with_precompute(
            self.cache, Xnew, full_cov=full_cov, full_output_cov=full_output_cov
        )
        return self._add_mean_function(Xnew, mean), cov

    @abstractmethod
    @check_shapes(
        "Xnew: [batch..., N, D]",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
    )
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        """Mean and covariance at Xnew, without mean function, from the cache."""

    def predict_mean(self, Xnew: torch.Tensor) -> torch.Tensor:
        """Predictive mean only; the fused route where there is no cache."""
        Xnew = input_to_tensor(self, Xnew)
        if self.cache is None:
            mean, _ = self.fused_predict_f(Xnew)
        else:
            mean, _ = self.predict_f(Xnew)
        return mean

    def update_cache(self, precompute_cache: Optional[PrecomputeCacheType] = None) -> None:
        """(Re)computes or clears the cache."""
        if precompute_cache is None:
            if self._precompute_cache is None:
                raise ValueError(
                    "You must pass precompute_cache explicitly (the cache had not been updated before)."
                )
            precompute_cache = self._precompute_cache
        else:
            precompute_cache = _validate_precompute_cache_type(precompute_cache)
            self._precompute_cache = precompute_cache

        if precompute_cache is PrecomputeCacheType.NOCACHE:
            self.cache = None
        else:  # TENSOR and VARIABLE both precompute into tensors
            self.cache = self._precompute()


class BasePosterior(AbstractPosterior):
    """q(u) posterior with the (alpha, Qinv) cache."""

    @check_shapes(
        "inducing_variable: [M, D, broadcast P]",
        "q_mu: [N, P]",
        "q_sqrt: [N, P] | [P, N, N]",
    )
    def __init__(
        self,
        kernel: kernels.Kernel,
        inducing_variable: InducingVariables,
        q_mu: Any,
        q_sqrt: Any,
        whiten: bool = True,
        mean_function: Optional[MeanFunction] = None,
        *,
        precompute_cache: Optional[PrecomputeCacheType],
    ) -> None:
        super().__init__(kernel, inducing_variable, mean_function=mean_function)
        self.whiten = whiten
        self._set_qdist(q_mu, q_sqrt)
        if precompute_cache is not None:
            self.update_cache(precompute_cache)

    @property
    @check_shapes(
        "return: [N, P]",
    )
    def q_mu(self) -> torch.Tensor:
        return _value(self._q_dist.q_mu)

    @property
    @check_shapes(
        "return: [N, P] | [P, N, N]",
    )
    def q_sqrt(self) -> Optional[torch.Tensor]:
        return _value(self._q_dist.q_sqrt)

    @check_shapes(
        "q_mu: [N, P]",
        "q_sqrt: [N, P] | [P, N, N]",
    )
    def _set_qdist(self, q_mu: Any, q_sqrt: Any) -> None:
        """Holds q(u)'s mean [M, L] and its square root: None, [M, L]
        (diagonal) or [L, M, M] (lower triangular), in a ``_DeltaDist``,
        ``_DiagNormal`` or ``_MvNormal`` by the rank of q_sqrt; numpy
        becomes tensors on the kernel's device."""
        q_mu, q_sqrt = input_to_tensor(self.kernel, q_mu), input_to_tensor(self.kernel, q_sqrt)
        if q_sqrt is None:
            self._q_dist: _QDistribution = _DeltaDist(q_mu)
        elif len(q_sqrt.shape) == 2:
            self._q_dist = _DiagNormal(q_mu, q_sqrt)
        else:
            self._q_dist = _MvNormal(q_mu, q_sqrt)

    @check_shapes(
        "return[0]: [M, L] | [L, M, 1]",
        "return[1]: [L, M, M]",
    )
    def _precompute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whitened: alpha = L^-T q_mu, Qinv = L^-T (I - S~) L^-1 with
        S~ = q_sqrt q_sqrt^T; unwhitened: alpha = Kuu^-1 q_mu and
        S~ = L^-1 S L^-T (``gpflow_tpu/posteriors.py:662-728``). A fully
        correlated Kuu [M, P, M, P] is taken as [MP, MP]; for a Kuu [L, M, M]
        q_mu becomes [L, M, 1] and the solves batch over L. Returns alpha
        [M, L] or [L, M, 1] and Qinv [L, M, M]."""
        Kuu_val = Kuu(self.X_data, self.kernel, jitter=default_jitter())  # [(L), M, M] or [M, P, M, P]
        q_mu = self.q_mu

        if Kuu_val.ndim == 4:
            ML = Kuu_val.shape[0] * Kuu_val.shape[1]
            Kuu_val = Kuu_val.reshape(ML, ML)
        if Kuu_val.ndim == 3:
            q_mu = q_mu.mT[..., None]  # [L, M, 1]
        L = cholesky(Kuu_val)

        if self.whiten:
            alpha = torch.linalg.solve_triangular(L.mT, q_mu, upper=True)
        else:
            alpha = torch.linalg.solve_triangular(
                L.mT, torch.linalg.solve_triangular(L, q_mu, upper=False), upper=True
            )

        I = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        q_sqrt = self.q_sqrt
        if q_sqrt is None:
            B = I
        else:
            if q_sqrt.ndim == 2:  # diagonal [M, L] -> [L, M, M]
                q_sqrt_full = torch.diag_embed(q_sqrt.mT)
            else:
                q_sqrt_full = q_sqrt
            if self.whiten:
                Linv_cov_u_LinvT = torch.matmul(q_sqrt_full, q_sqrt_full.mT)
            else:
                Linv_qsqrt = torch.linalg.solve_triangular(L, q_sqrt_full, upper=False)
                Linv_cov_u_LinvT = torch.matmul(Linv_qsqrt, Linv_qsqrt.mT)
            B = I - Linv_cov_u_LinvT

        if B.ndim == 2 and L.ndim == 3:  # no q_sqrt, Kuu [L, M, M]
            B = B.expand(L.shape[:-2] + B.shape)
        L_b = L.expand(B.shape[:-2] + L.shape[-2:]) if B.ndim == 3 and L.ndim == 2 else L
        LinvT_B = torch.linalg.solve_triangular(L_b.mT, B, upper=True)
        Qinv = torch.linalg.solve_triangular(L_b.mT, LinvT_B.mT, upper=True)

        num_latent = self.q_mu.shape[-1]
        Qinv = Qinv.expand((num_latent,) + Qinv.shape[-2:])
        return alpha, Qinv


class IndependentPosterior(BasePosterior):
    @check_shapes(
        "mean: [batch..., N, P]",
        "cov: [batch..., P, N, N] if full_cov",
        "cov: [batch..., N, P] if not full_cov",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    )
    def _post_process_mean_and_cov(
        self, mean: torch.Tensor, cov: torch.Tensor, full_cov: bool, full_output_cov: bool
    ) -> MeanAndVariance:
        return mean, expand_independent_outputs(cov, full_cov, full_output_cov)

    @check_shapes(
        "Xnew: [N, D]",
        "return: [P, N, N] | [N, N] if full_cov",
        "return: [P, N] | [N] if not full_cov",
    )
    def _get_Kff(self, Xnew: torch.Tensor, full_cov: bool) -> torch.Tensor:
        """Kff of each latent kernel: a multioutput kernel's own call would
        give the output-covariance layout (``posteriors.py:754-762``)."""
        if isinstance(self.kernel, (kernels.SeparateIndependent, kernels.IndependentLatent)):
            return torch.stack([k(Xnew, full_cov=full_cov) for k in self.kernel.kernels], dim=0)
        if isinstance(self.kernel, kernels.MultioutputKernel):
            return self.kernel.kernel(Xnew, full_cov=full_cov)
        return self.kernel(Xnew, full_cov=full_cov)

    def _cached_mean(self, alpha: torch.Tensor, Kuf_val: torch.Tensor) -> torch.Tensor:
        """Kuf^T alpha: [N, L] from Kuf [M, N] and alpha [M, L], or from Kuf
        [L, M, N] and alpha [L, M, 1]."""
        mean = torch.matmul(Kuf_val.mT, alpha)
        if Kuf_val.ndim == 3:
            mean = mean.squeeze(-1).mT  # [N, L]
        return mean

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        alpha, Qinv = cache  # alpha: [M, L] or [L, M, 1]; Qinv: [L, M, M]
        Kuf_val = Kuf(self.X_data, self.kernel, Xnew)  # [(L), M, N]
        Kff = self._get_Kff(Xnew, full_cov)

        mean = self._cached_mean(alpha, Kuf_val)
        if full_cov:
            cov = Kff - torch.matmul(Kuf_val.mT, torch.matmul(Qinv, Kuf_val))  # [L, N, N]
        else:
            cov = Kff - torch.sum(Kuf_val * torch.matmul(Qinv, Kuf_val), dim=-2)  # [L, N]
            cov = cov.mT  # [N, L]
        return self._post_process_mean_and_cov(mean, cov, full_cov, full_output_cov)

    def _mix_mean(self, mean: torch.Tensor) -> torch.Tensor:
        return mean

    def predict_mean(self, Xnew: torch.Tensor) -> torch.Tensor:
        """mean = Kuf^T alpha from the cache, skipping the O(M^2 N) Qinv term."""
        Xnew = input_to_tensor(self, Xnew)
        if self.cache is None:
            return super().predict_mean(Xnew)
        alpha, _ = self.cache
        Kuf_val = Kuf(self.X_data, self.kernel, Xnew)  # [(L), M, N]
        return self._add_mean_function(Xnew, self._mix_mean(self._cached_mean(alpha, Kuf_val)))


class IndependentPosteriorSingleOutput(IndependentPosterior):
    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        Knn = self.kernel(Xnew, full_cov=full_cov)
        # Kuf before Kuu: with the checks on, an Xnew whose D is not Z's
        # fails the kernel's contract before Kuu is computed (the parameters
        # are first read in the JAX package's order all the same)
        Kmn = Kuf(self.X_data, self.kernel, Xnew)  # [M, N]
        Kmm = Kuu(self.X_data, self.kernel, jitter=default_jitter())  # [M, M]
        fmean, fvar = base_conditional(
            Kmn, Kmm, Knn, self.q_mu, full_cov=full_cov, q_sqrt=self.q_sqrt, white=self.whiten
        )
        return self._post_process_mean_and_cov(fmean, fvar, full_cov, full_output_cov)


class GPRPosterior(AbstractPosterior):
    """Exact-GP posterior; cache = (err, Lm, alpha) with Lm the Cholesky
    factor of K(X, X) + sigma^2 I and alpha = (K + sigma^2 I)^-1 err
    (``gpflow_tpu/posteriors.py:326-414``)."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, Q]",
    )
    def __init__(
        self,
        kernel: kernels.Kernel,
        data: Tuple[torch.Tensor, torch.Tensor],
        likelihood: Gaussian,
        mean_function: MeanFunction,
        *,
        precompute_cache: Optional[PrecomputeCacheType],
    ) -> None:
        X, Y = data
        super().__init__(kernel, X, mean_function=mean_function)
        self.Y_data = input_to_tensor(kernel, Y)
        self.likelihood = likelihood
        if precompute_cache is not None:
            self.update_cache(precompute_cache)

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        assert_params_false(self._conditional_with_precompute, full_output_cov=full_output_cov)
        err, Lm = cache[0], cache[1]
        Knn = self.kernel(Xnew, full_cov=full_cov)
        Kmn = self.kernel(self.X_data, Xnew)
        return base_conditional_with_lm(
            Kmn=Kmn, Lm=Lm, Knn=Knn, f=err, full_cov=full_cov, q_sqrt=None, white=False
        )

    def predict_mean(self, Xnew: torch.Tensor) -> torch.Tensor:
        """mean = Kmn^T alpha with alpha from the cache: the [N, Nnew] Kmn and
        one matvec, no solve."""
        Xnew = input_to_tensor(self, Xnew)
        if self.cache is None:
            return super().predict_mean(Xnew)
        alpha = self.cache[2]
        Kmn = self.kernel(self.X_data, Xnew)
        return self._add_mean_function(Xnew, torch.matmul(Kmn.mT, alpha))

    @check_shapes(
        "return[0]: [M, D]",
        "return[1]: [M, M]",
    )
    def _precompute_base(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(err, Lm): what the full conditional needs."""
        err = self.Y_data - self.mean_function(self.X_data)
        Kmm = self.kernel(self.X_data)
        Lm = cholesky(add_likelihood_noise_cov(Kmm, self.likelihood, self.X_data))
        return err, Lm

    @check_shapes(
        "return[0]: [M, D]",
        "return[1]: [M, M]",
        "return[2]: [M, D]",
    )
    def _precompute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        err, Lm = self._precompute_base()
        alpha = torch.linalg.solve_triangular(
            Lm.mT, torch.linalg.solve_triangular(Lm, err, upper=False), upper=True
        )
        return err, Lm, alpha

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        return self._conditional_with_precompute(self._precompute_base(), Xnew, full_cov, full_output_cov)


def sgpr_conditional(
    kernel: kernels.Kernel,
    inducing_variable: InducingPoints,
    num_latent_gps: int,
    L: torch.Tensor,
    LB: torch.Tensor,
    c: torch.Tensor,
    Xnew: torch.Tensor,
    full_cov: bool = False,
) -> MeanAndVariance:
    """The SGPR conditional at Xnew from L = chol(Kuu), LB and c (see
    ``SGPRPosterior``), without the mean function: the one ``SGPRPosterior``,
    the fused ``SGPR_deprecated.predict_f`` and ``CGLB.predict_f`` share."""
    Kus = Kuf(inducing_variable, kernel, Xnew)
    tmp1 = torch.linalg.solve_triangular(L, Kus, upper=False)
    tmp2 = torch.linalg.solve_triangular(LB, tmp1, upper=False)
    mean = torch.matmul(tmp2.mT, c)
    if full_cov:
        var = kernel(Xnew) + torch.matmul(tmp2.mT, tmp2) - torch.matmul(tmp1.mT, tmp1)
        var = var[None, ...].expand((num_latent_gps,) + var.shape)
    else:
        var = kernel(Xnew, full_cov=False) + torch.sum(torch.square(tmp2), 0) - torch.sum(torch.square(tmp1), 0)
        var = var[:, None].expand(var.shape + (num_latent_gps,))
    return mean, var


class SGPRPosterior(AbstractPosterior):
    """SGPR posterior; cache = (L, LB, c, alpha) with L = chol(Kuu),
    LB = chol(I + A A^T) for A = L^-1 Kuf / sigma, c = LB^-1 A err / sigma
    and alpha = L^-T LB^-T c (``gpflow_tpu/posteriors.py:417-538``)."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, Q]",
        "inducing_variable: [M, D, 1]",
    )
    def __init__(
        self,
        kernel: kernels.Kernel,
        data: Tuple[torch.Tensor, torch.Tensor],
        inducing_variable: InducingPoints,
        likelihood: Gaussian,
        num_latent_gps: int,
        mean_function: MeanFunction,
        *,
        precompute_cache: Optional[PrecomputeCacheType],
    ) -> None:
        X, Y = data
        super().__init__(kernel, X, mean_function=mean_function)
        self.Y_data = input_to_tensor(kernel, Y)
        self.likelihood = likelihood
        self.inducing_variable = inducing_variable
        self.num_latent_gps = num_latent_gps
        if precompute_cache is not None:
            self.update_cache(precompute_cache)

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        assert_params_false(self._conditional_with_precompute, full_output_cov=full_output_cov)
        return sgpr_conditional(self.kernel, self.inducing_variable, self.num_latent_gps, cache[0], cache[1],
                                cache[2], Xnew, full_cov)

    @check_shapes(
        "return[0]: [M, M]",
        "return[1]: [M, M]",
        "return[2]: [M, D]",
    )
    def _precompute_base(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(L, LB, c): what the full conditional needs."""
        err = self.Y_data - self.mean_function(self.X_data)

        kuf = Kuf(self.inducing_variable, self.kernel, self.X_data)
        kuu = Kuu(self.inducing_variable, self.kernel, jitter=default_jitter())

        sigma_sq = self.likelihood.variance_at(self.X_data).squeeze(-1)
        sigma = torch.sqrt(sigma_sq)

        L = cholesky(kuu)
        A = torch.linalg.solve_triangular(L, kuf / sigma, upper=False)
        rows = rows_of(self)
        B = rows.sum(torch.matmul(A, A.mT)) + torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        LB = cholesky(B)
        Aerr = rows.sum(torch.matmul(A, err / sigma[..., None]))
        c = torch.linalg.solve_triangular(LB, Aerr, upper=False)
        return L, LB, c

    @check_shapes(
        "return[0]: [M, M]",
        "return[1]: [M, M]",
        "return[2]: [M, D]",
        "return[3]: [M, D]",
    )
    def _precompute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        L, LB, c = self._precompute_base()
        # alpha for one-matvec mean-only serving, computed here and not on
        # the fused (NOCACHE) route
        alpha = torch.linalg.solve_triangular(
            L.mT, torch.linalg.solve_triangular(LB.mT, c, upper=True), upper=True
        )
        return L, LB, c, alpha

    def predict_mean(self, Xnew: torch.Tensor) -> torch.Tensor:
        """mean = Kus^T alpha with alpha from the cache: the [M, M] solves act
        on the [M, P] vector c, not on the [M, Nnew] Kus."""
        Xnew = input_to_tensor(self, Xnew)
        if self.cache is None:
            return super().predict_mean(Xnew)
        alpha = self.cache[3]
        Kus = Kuf(self.inducing_variable, self.kernel, Xnew)
        return self._add_mean_function(Xnew, torch.matmul(Kus.mT, alpha))

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        return self._conditional_with_precompute(self._precompute_base(), Xnew, full_cov, full_output_cov)


class VGPPosterior(AbstractPosterior):
    """VGP posterior over function values at the data X; cache = (Lm,), the
    Cholesky factor of K(X) + jitter I (``gpflow_tpu/posteriors.py:541-607``).
    A request solves against Lm through ``base_conditional_with_lm``."""

    @check_shapes(
        "X: [N, D]",
        "q_mu: [N, P]",
        "q_sqrt: [N, P] | [P, N, N]",
    )
    def __init__(
        self,
        kernel: kernels.Kernel,
        X: torch.Tensor,
        q_mu: Any,
        q_sqrt: Any,
        mean_function: Optional[MeanFunction] = None,
        white: bool = True,
        *,
        precompute_cache: Optional[PrecomputeCacheType],
    ) -> None:
        super().__init__(kernel, X, mean_function=mean_function)
        self.q_mu = input_to_tensor(kernel, q_mu)
        self.q_sqrt = input_to_tensor(kernel, q_sqrt)
        self.white = white
        if precompute_cache is not None:
            self.update_cache(precompute_cache)

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        assert_params_false(self._conditional_with_precompute, full_output_cov=full_output_cov)
        (Lm,) = cache
        Kmn = self.kernel(self.X_data, Xnew)
        Knn = self.kernel(Xnew, full_cov=full_cov)
        return base_conditional_with_lm(
            Kmn=Kmn,
            Lm=Lm,
            Knn=Knn,
            f=_value(self.q_mu),
            full_cov=full_cov,
            q_sqrt=_value(self.q_sqrt),
            white=self.white,
        )

    @check_shapes(
        "return[0]: [M, M]",
    )
    def _precompute(self) -> Tuple[torch.Tensor]:
        Kmm = self.kernel(self.X_data)
        M = Kmm.shape[-1]
        Lm = cholesky(Kmm + default_jitter() * torch.eye(M, dtype=Kmm.dtype, device=Kmm.device))
        return (Lm,)

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        return self._conditional_with_precompute(self._precompute(), Xnew, full_cov, full_output_cov)


class IndependentPosteriorMultiOutput(IndependentPosterior):
    """Independent outputs or latent GPs (``posteriors.py:823-858``): shared
    inducing points and a shared kernel through ``base_conditional`` with one
    [M, M] Kuu; otherwise each output on its own Kuu [P, M, M] and Kuf
    [P, M, N], as one batched conditional. Where the latent GPs are split
    over ranks (q_mu and q_sqrt then hold this rank's), each rank conditions
    its own and the marginals are gathered before any mixing."""

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        latents = latents_of(self)
        fmean, fvar = self._latent_conditional(Xnew, full_cov, latents.start)
        if latents is not WHOLE:
            fmean = latents.gather(fmean, dim=-1)
            fvar = latents.gather(fvar, dim=-3 if full_cov else -1)
        return self._post_process_mean_and_cov(fmean, fvar, full_cov, full_output_cov)

    def _latent_conditional(self, Xnew: torch.Tensor, full_cov: bool, start: int = 0) -> MeanAndVariance:
        """The marginals, before any mixing, of the latent GPs that q_mu
        holds: all of them, or where they are split over ranks this rank's,
        ``start`` onwards. One [M, M] Kuu where the kernel and the inducing
        points are shared; otherwise each latent GP on its own kernel and
        inducing variable, stacked into one batched conditional."""
        shared_iv = isinstance(self.X_data, SharedIndependentInducingVariables)
        if shared_iv and isinstance(self.kernel, kernels.SharedIndependent):
            Knn = self.kernel.kernel(Xnew, full_cov=full_cov)
            Kmm = Kuu(self.X_data, self.kernel, jitter=default_jitter())  # [M, M]
            Kmn = Kuf(self.X_data, self.kernel, Xnew)  # [M, N]
            return base_conditional(
                Kmn, Kmm, Knn, self.q_mu, full_cov=full_cov, q_sqrt=self.q_sqrt, white=self.whiten
            )
        count = self.q_mu.shape[-1]
        if isinstance(self.kernel, kernels.Combination):
            kernel_list = list(self.kernel.kernels)[start:start + count]
        else:
            kernel_list = [self.kernel.kernel] * count
        if shared_iv:
            iv_list = [self.X_data.inducing_variable] * count
        else:
            iv_list = list(self.X_data.inducing_variable_list)[start:start + count]
        if not len(kernel_list) == len(iv_list) == count:
            raise ValueError(
                f"{count} latent GPs in q_mu, but {len(kernel_list)} kernels and {len(iv_list)} "
                f"inducing variables from latent GP {start} on"
            )
        Kmms = torch.stack([Kuu(iv, k, jitter=default_jitter()) for iv, k in zip(iv_list, kernel_list)])  # [L, M, M]
        Kmns = torch.stack([Kuf(iv, k, Xnew) for iv, k in zip(iv_list, kernel_list)])  # [L, M, N]
        Knns = torch.stack([k.K(Xnew) if full_cov else k.K_diag(Xnew) for k in kernel_list], dim=0)
        fmean, fvar = separate_independent_conditional_implementation(
            Kmns, Kmms, Knns, self.q_mu, q_sqrt=self.q_sqrt, full_cov=full_cov, white=self.whiten,
        )
        # [L, batch..., N, N] -> batch-leading, as the shared branch gives it
        return fmean, torch.movedim(fvar, 0, -3) if full_cov else fvar


class LinearCoregionalizationPosterior(IndependentPosteriorMultiOutput):
    """Conditions the L latent GPs, then mixes them with W
    (``posteriors.py:861-886``)."""

    def _mix_mean(self, mean: torch.Tensor) -> torch.Tensor:
        return torch.matmul(mean, self.kernel.W.value.mT)  # [..., N, L] -> [..., N, P]

    @check_shapes(
        "mean: [batch..., N, L]",
        "cov: [batch..., L, N, N] if full_cov",
        "cov: [batch..., N, L] if not full_cov",
        "return[0]: [batch..., N, P]",
        "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
        "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
        "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
        "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    )
    def _post_process_mean_and_cov(
        self, mean: torch.Tensor, cov: torch.Tensor, full_cov: bool, full_output_cov: bool
    ) -> MeanAndVariance:
        cov = expand_independent_outputs(cov, full_cov, full_output_cov=False)
        if full_cov:
            cov = torch.movedim(cov, -3, 0)  # mix_latent_gp takes [L, batch..., N, N]
        return mix_latent_gp(self.kernel.W.value, mean, cov, full_cov, full_output_cov)


class FullyCorrelatedPosterior(BasePosterior):
    """All outputs conditioned jointly through Kuu [M, P, M, P] and Kuf
    [M, P, N, P], flattened to [MP, MP] and [MP, NP]
    (``posteriors.py:889-972``)."""

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        alpha, Qinv = cache

        Kuf_val = Kuf(self.X_data, self.kernel, Xnew)
        assert Kuf_val.ndim == 4
        M, L, N, K = Kuf_val.shape
        Kuf_val = Kuf_val.reshape(M * L, N * K)

        Kff = self.kernel(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        if full_cov == full_output_cov:
            Kff = Kff.reshape((N * K, N * K) if full_cov else (N * K,))

        mean = torch.matmul(Kuf_val.mT, alpha)  # [NK, R]

        if not full_cov and not full_output_cov:
            cov = Kff - torch.sum(Kuf_val * torch.matmul(Qinv, Kuf_val), dim=-2)
            cov = cov.mT if cov.ndim > 1 else cov
        else:
            Kfu_Qinv_Kuf = torch.matmul(Kuf_val.mT, torch.matmul(Qinv, Kuf_val))
            if not (full_cov and full_output_cov):
                Kfu_Qinv_Kuf = Kfu_Qinv_Kuf.reshape(Kfu_Qinv_Kuf.shape[:-2] + (N, K, N, K))
                if full_cov:  # diagonal in the outputs
                    tmp = torch.diagonal(torch.einsum("...ijkl->...ikjl", Kfu_Qinv_Kuf), dim1=-2, dim2=-1)
                else:  # diagonal in the inputs
                    tmp = torch.diagonal(torch.einsum("...ijkl->...jlik", Kfu_Qinv_Kuf), dim1=-2, dim2=-1)
                Kfu_Qinv_Kuf = torch.einsum("...ijk->...kij", tmp)
            cov = Kff - Kfu_Qinv_Kuf

        mean = mean.reshape(N, K)
        if full_cov == full_output_cov:
            cov_shape = (N, K, N, K) if full_cov else (N, K)
        else:
            cov_shape = (K, N, N) if full_cov else (N, K, K)
        return mean, cov.reshape(cov_shape)

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        Kmm = Kuu(self.X_data, self.kernel, jitter=default_jitter())  # [M, L, M, L]
        Kmn = Kuf(self.X_data, self.kernel, Xnew)  # [M, L, N, P]
        Knn = self.kernel(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)

        M, L, N, K = Kmn.shape
        Kmm = Kmm.reshape(M * L, M * L)

        if full_cov == full_output_cov:
            Kmn = Kmn.reshape(M * L, N * K)
            Knn = Knn.reshape((N * K, N * K) if full_cov else (N * K,))
            mean, cov = base_conditional(
                Kmn, Kmm, Knn, self.q_mu, full_cov=full_cov, q_sqrt=self.q_sqrt, white=self.whiten
            )
            mean = mean.reshape(N, K)
            cov = cov.reshape((N, K, N, K) if full_cov else (N, K))
        else:
            mean, cov = fully_correlated_conditional(
                Kmn.reshape(M * L, N, K), Kmm, Knn, self.q_mu,
                full_cov=full_cov, full_output_cov=full_output_cov, q_sqrt=self.q_sqrt, white=self.whiten,
            )
        return mean, cov


class FallbackIndependentLatentPosterior(FullyCorrelatedPosterior):
    """Independent latent GPs through the interdomain Kuf [M, L, N, P]
    (``posteriors.py:975-1027``). The cache holds per-latent alpha
    [L, M, 1] and Qinv [L, M, M] (Kuu is [L, M, M]), so it serves any number
    of latent GPs, as the JAX package's extension of the reference does."""

    @inherit_check_shapes
    def _conditional_with_precompute(
        self,
        cache: Tuple[torch.Tensor, ...],
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
    ) -> MeanAndVariance:
        alpha, Qinv = cache  # alpha: [L, M, 1], Qinv: [L, M, M]

        Kuf_val = Kuf(self.X_data, self.kernel, Xnew)  # [M, L, N, P]
        assert Kuf_val.ndim == 4
        Kff = self.kernel(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)

        mean = torch.einsum("mlnp,lm->np", Kuf_val, alpha[..., 0])
        proj = torch.einsum("lmo,mlnp->lonp", Qinv, Kuf_val)  # sum_m Qinv[l, m, o] Kuf[m, l, n, p]
        if full_cov and full_output_cov:
            cov = Kff - torch.einsum("lonp,olqr->npqr", proj, Kuf_val)  # [N, P, N, P]
        elif full_cov:
            cov = Kff - torch.einsum("lonp,olqp->pnq", proj, Kuf_val)  # [P, N, N]
        elif full_output_cov:
            cov = Kff - torch.einsum("lonp,olnr->npr", proj, Kuf_val)  # [N, P, P]
        else:
            cov = Kff - torch.einsum("lonp,olnp->np", proj, Kuf_val)  # [N, P]
        return mean, cov

    @inherit_check_shapes
    def _conditional_fused(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        Kmm = Kuu(self.X_data, self.kernel, jitter=default_jitter())  # [L, M, M]
        Kmn = Kuf(self.X_data, self.kernel, Xnew)  # [M, L, N, P]
        Knn = self.kernel(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
        return independent_interdomain_conditional(
            Kmn, Kmm, Knn, self.q_mu,
            full_cov=full_cov, full_output_cov=full_output_cov, q_sqrt=self.q_sqrt, white=self.whiten,
        )


get_posterior_class = Dispatcher("get_posterior_class")


@get_posterior_class.register(kernels.Kernel, InducingVariables)
def _get_posterior_base_case(
    kernel: kernels.Kernel, inducing_variable: InducingVariables
) -> Type[BasePosterior]:
    return IndependentPosteriorSingleOutput


@get_posterior_class.register(kernels.MultioutputKernel, InducingPoints)
def _get_posterior_fully_correlated_mo(
    kernel: kernels.Kernel, inducing_variable: InducingVariables
) -> Type[BasePosterior]:
    return FullyCorrelatedPosterior


def _get_posterior_independent_mo(
    kernel: kernels.Kernel, inducing_variable: InducingVariables
) -> Type[BasePosterior]:
    return IndependentPosteriorMultiOutput


for _k in (kernels.SharedIndependent, kernels.SeparateIndependent):
    for _iv in (SeparateIndependentInducingVariables, SharedIndependentInducingVariables):
        get_posterior_class.add((_k, _iv), _get_posterior_independent_mo)


def _get_posterior_independentlatent_mo_fallback(
    kernel: kernels.Kernel, inducing_variable: InducingVariables
) -> Type[BasePosterior]:
    return FallbackIndependentLatentPosterior


for _iv in (FallbackSeparateIndependentInducingVariables, FallbackSharedIndependentInducingVariables):
    get_posterior_class.add((kernels.IndependentLatent, _iv), _get_posterior_independentlatent_mo_fallback)


def _get_posterior_linearcoregionalization_mo_efficient(
    kernel: kernels.Kernel, inducing_variable: InducingVariables
) -> Type[BasePosterior]:
    return LinearCoregionalizationPosterior


for _iv in (SeparateIndependentInducingVariables, SharedIndependentInducingVariables):
    get_posterior_class.add(
        (kernels.LinearCoregionalization, _iv), _get_posterior_linearcoregionalization_mo_efficient
    )


def create_posterior(
    kernel: kernels.Kernel,
    inducing_variable: InducingVariables,
    q_mu: Any,
    q_sqrt: Any,
    whiten: bool,
    mean_function: Optional[MeanFunction] = None,
    precompute_cache: Union[PrecomputeCacheType, str, None] = PrecomputeCacheType.TENSOR,
) -> BasePosterior:
    """The posterior class for (kernel, inducing variable), built and, unless
    NOCACHE, with its cache computed."""
    posterior_class = get_posterior_class(kernel, inducing_variable)
    precompute_cache = _validate_precompute_cache_type(precompute_cache)
    return posterior_class(
        kernel, inducing_variable, q_mu, q_sqrt, whiten, mean_function,
        precompute_cache=precompute_cache,
    )

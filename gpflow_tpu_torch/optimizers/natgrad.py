"""Natural-gradient optimizer for (q_mu, q_sqrt) variational parameters
(Salimbeni et al. 2018, eq. 10; counterpart of
``gpflow_tpu/optimizers/natgrad.py``).

A step maps the loss gradient with respect to (q_mu, q_sqrt) to the
expectation parameters eta = (m, S + m m^T) by the VJP of
``expectation_to_meanvarsqrt`` (``torch.func.vjp``), which is the natural
gradient in the natural parameters; for another xi parameterization it is
pushed forward through ``naturals_to_xi`` by a JVP (``torch.func.jvp``).
The conversions' Choleskys go through ``ops.linalg.cholesky``, which gives
NaN and never raises: a step that leaves the negative-definite cone is
rejected on the device (``torch.where``), with no host synchronisation.
"""
from __future__ import annotations

import abc
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..base import Parameter, array_inputs
from ..bijectors import Bijector
from ..ops.linalg import cholesky as _cholesky
from ..ops.linalg import sym_jitter as _sym_jitter
from ..utilities.shapes import check_shapes

__all__ = [
    "NaturalGradient",
    "XiNat",
    "XiSqrtMeanVar",
    "XiTransform",
    "expectation_to_meanvarsqrt",
    "expectation_to_natural",
    "meanvarsqrt_to_expectation",
    "meanvarsqrt_to_natural",
    "natural_to_expectation",
    "natural_to_meanvarsqrt",
]

LossClosure = Callable[[], torch.Tensor]


class XiTransform(metaclass=abc.ABCMeta):
    """A parameterization xi in which natural-gradient steps are taken
    (``natgrad.py:46-81``). Means are [N, D], square roots and second
    parameters [D, N, N]."""

    @staticmethod
    @abc.abstractmethod
    @check_shapes(
        "mean: [N, D]",
        "varsqrt: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def meanvarsqrt_to_xi(mean: torch.Tensor, varsqrt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    @staticmethod
    @abc.abstractmethod
    @check_shapes(
        "xi1: [N, D]",
        "xi2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def xi_to_meanvarsqrt(xi1: torch.Tensor, xi2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

    @staticmethod
    @abc.abstractmethod
    @check_shapes(
        "nat1: [N, D]",
        "nat2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def naturals_to_xi(nat1: torch.Tensor, nat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ...


class XiNat(XiTransform):
    """xi = the natural parameters, the default: with a Gaussian likelihood
    one step of gamma = 1 reaches the optimum (``natgrad.py:84-116``)."""

    @staticmethod
    @check_shapes(
        "mean: [N, D]",
        "varsqrt: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def meanvarsqrt_to_xi(mean: torch.Tensor, varsqrt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return meanvarsqrt_to_natural(mean, varsqrt)

    @staticmethod
    @check_shapes(
        "xi1: [N, D]",
        "xi2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def xi_to_meanvarsqrt(xi1: torch.Tensor, xi2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return natural_to_meanvarsqrt(xi1, xi2)

    @staticmethod
    @check_shapes(
        "nat1: [N, D]",
        "nat2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def naturals_to_xi(nat1: torch.Tensor, nat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return nat1, nat2


class XiSqrtMeanVar(XiTransform):
    """xi = (mean, varsqrt), the model's own parameters (``natgrad.py:119-151``)."""

    @staticmethod
    @check_shapes(
        "mean: [N, D]",
        "varsqrt: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def meanvarsqrt_to_xi(mean: torch.Tensor, varsqrt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mean, varsqrt

    @staticmethod
    @check_shapes(
        "xi1: [N, D]",
        "xi2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def xi_to_meanvarsqrt(xi1: torch.Tensor, xi2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return xi1, xi2

    @staticmethod
    @check_shapes(
        "nat1: [N, D]",
        "nat2: [D, N, N]",
        "return[0]: [N, D]",
        "return[1]: [D, N, N]",
    )
    def naturals_to_xi(nat1: torch.Tensor, nat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return natural_to_meanvarsqrt(nat1, nat2)


NatGradParameters = Union[Tuple[Parameter, Parameter], Tuple[Parameter, Parameter, XiTransform]]


class NaturalGradient:
    """Natural-gradient descent on q(u) = N(q_mu, q_sqrt q_sqrt^T) with the
    full-covariance q_sqrt [L, M, M] (``natgrad.py:159-440``); ``q_diag`` is
    not supported. ``gamma`` is read at every step, so it can be annealed.
    ``compile`` is accepted for the JAX package's signature and changes
    nothing: steps run eagerly, as ``training_loss_closure`` does."""

    def __init__(self, gamma: float, xi_transform: Optional[XiTransform] = None, compile: bool = True) -> None:
        self.gamma = gamma
        self.xi_transform = xi_transform if xi_transform is not None else XiNat()
        self.compile = compile

    def get_config(self) -> Dict[str, Any]:
        """A plain dict for checkpoint metadata (``natgrad.py:176-179``)."""
        return {"name": type(self).__name__, "gamma": float(self.gamma)}

    @check_shapes(
        "var_list[all][0]: [N, D]",
        "var_list[all][1]: [D, N, N]",
    )
    def minimize(self, loss_fn: LossClosure, var_list: Sequence[NatGradParameters]) -> None:
        """One natural-gradient step on each (q_mu, q_sqrt[, xi]) tuple of
        ``var_list``, from one gradient of ``loss_fn()`` with respect to all
        of them (``natgrad.py:185-203``). The gradient is taken with
        ``torch.autograd.grad``, so no ``.grad`` of any tensor changes."""
        parameters = [(v[0], v[1], (v[2] if len(v) > 2 else None)) for v in var_list]
        self._natgrad_steps(loss_fn, parameters)

    @check_shapes(
        "parameters[all][0]: [N, D]",
        "parameters[all][1]: [D, N, N]",
    )
    def _natgrad_steps(
        self,
        loss_fn: LossClosure,
        parameters: Sequence[Tuple[Parameter, Parameter, Optional[XiTransform]]],
    ) -> None:
        """The step of ``minimize`` on (q_mu, q_sqrt, xi) triples
        (``natgrad.py:320-334``)."""
        for _, q_sqrt, _ in parameters:
            if q_sqrt.value.ndim != 3:
                raise ValueError(
                    "NaturalGradient only supports the full-covariance parametrization "
                    "q_sqrt: [L, M, M] (q_diag=True is not supported)."
                )
        leaves = [p.unconstrained for q_mu, q_sqrt, _ in parameters for p in (q_mu, q_sqrt)]
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(), leaves)
        for i, (q_mu, q_sqrt, xi_transform) in enumerate(parameters):
            self._natgrad_apply_gradients(grads[2 * i], grads[2 * i + 1], q_mu, q_sqrt, xi_transform)

    def _natgrad_values_with_ok(
        self,
        q_mu_grad: torch.Tensor,
        q_sqrt_grad: torch.Tensor,
        q_mu_value: torch.Tensor,
        q_sqrt_value: torch.Tensor,
        mu_transform: Bijector,
        sqrt_transform: Bijector,
        xi_transform: XiTransform,
        agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The new (mean, varsqrt) and the acceptance flag, a boolean device
        tensor (``natgrad.py:358-406``), for a step of ``self.gamma``. Where
        the step leaves the negative-definite cone a conversion's Cholesky is
        NaN; the step is then rejected and the values are returned unchanged,
        branch-free. Where the latent GPs are split over ranks, each rank
        converts its own and ``agree`` makes the flag the ranks' AND, so that
        a step is taken or rejected for all latent GPs together, as in the
        JAX package."""
        with torch.no_grad():
            q_mu_value, q_sqrt_value = q_mu_value.detach(), q_sqrt_value.detach()
            dL_dmean = mu_transform.forward(q_mu_grad)
            dL_dvarsqrt = sqrt_transform.forward(q_sqrt_grad)
            eta1, eta2 = meanvarsqrt_to_expectation(q_mu_value, q_sqrt_value)
        with torch.enable_grad():
            _, vjp_fn = torch.func.vjp(expectation_to_meanvarsqrt, eta1, eta2)
            dL_deta1, dL_deta2 = vjp_fn((dL_dmean, dL_dvarsqrt))
            if not isinstance(xi_transform, XiNat):
                nat1, nat2 = meanvarsqrt_to_natural(q_mu_value, q_sqrt_value)
                _, (nat_dL_xi1, nat_dL_xi2) = torch.func.jvp(
                    xi_transform.naturals_to_xi, (nat1, nat2), (dL_deta1, dL_deta2)
                )
            else:
                nat_dL_xi1, nat_dL_xi2 = dL_deta1, dL_deta2
        with torch.no_grad():
            xi1, xi2 = xi_transform.meanvarsqrt_to_xi(q_mu_value, q_sqrt_value)
            mean_new, varsqrt_new = xi_transform.xi_to_meanvarsqrt(
                xi1 - self.gamma * nat_dL_xi1.detach(), xi2 - self.gamma * nat_dL_xi2.detach()
            )
            ok = torch.isfinite(mean_new).all() & torch.isfinite(varsqrt_new).all()
            if agree is not None:
                ok = agree(ok)
            mean_new = torch.where(ok, mean_new, q_mu_value)
            varsqrt_new = torch.where(ok, varsqrt_new, q_sqrt_value)
        return mean_new, varsqrt_new, ok

    @check_shapes(
        "q_mu_grad: [N, D]",
        "q_sqrt_grad: [D, N_N_transformed...]",
        "q_mu: [N, D]",
        "q_sqrt: [D, N, N]",
    )
    def _natgrad_apply_gradients(
        self,
        q_mu_grad: torch.Tensor,
        q_sqrt_grad: torch.Tensor,
        q_mu: Parameter,
        q_sqrt: Parameter,
        xi_transform: Optional[XiTransform] = None,
        agree: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """One natural-gradient step on (q_mu, q_sqrt) from the gradients of
        their unconstrained tensors (``natgrad.py:408-440``), written in
        place; returns the acceptance flag."""
        if xi_transform is None:
            xi_transform = self.xi_transform
        if q_sqrt.value.ndim != 3:
            raise ValueError(
                "NaturalGradient only supports the full-covariance parametrization "
                "q_sqrt: [L, M, M]; the diagonal q_diag=True parametrization is not "
                "supported (same restriction as the reference implementation)."
            )
        mean_new, varsqrt_new, ok = self._natgrad_values_with_ok(
            q_mu_grad, q_sqrt_grad, q_mu.value, q_sqrt.value, q_mu.transform, q_sqrt.transform, xi_transform,
            agree,
        )
        with torch.no_grad():
            q_mu._set_unconstrained(q_mu.transform.inverse(mean_new))
            q_sqrt._set_unconstrained(q_sqrt.transform.inverse(varsqrt_new))
        return ok


# ---------------------------------------------------------------------------
# Gaussian parameter conversions (``natgrad.py:443-573``). The raw functions
# take a leading [D] dimension, [D, N, 1] and [D, N, N]; ``swap_dimensions``
# adapts them to the [N, D] layout of q_mu.
# ---------------------------------------------------------------------------


def swap_dimensions(
    method: Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """With ``swap=True`` (the default) the first argument and result are
    [N, D]; with ``swap=False`` they are [D, N, 1] (``natgrad.py:450-470``)."""

    @functools.wraps(method)
    @array_inputs("a_nd", "b_dnn")
    @check_shapes(
        "a_nd: [N, D] if swap",
        "a_nd: [D, N, 1] if not swap",
        "b_dnn: [D, N, N]",
        "return[0]: [N, D] if swap",
        "return[0]: [D, N, 1] if not swap",
        "return[1]: [D, N, N]",
    )
    def wrapper(a_nd: torch.Tensor, b_dnn: torch.Tensor, swap: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        if swap:
            A_dn1, B_dnn = method(a_nd.mT[:, :, None], b_dnn)
            return A_dn1[:, :, 0].mT, B_dnn
        return method(a_nd, b_dnn)

    return wrapper


@check_shapes(
    "M: [D, N, N]",
    "return: [D, N, N]",
)
def _inverse_lower_triangular(M: torch.Tensor) -> torch.Tensor:
    """Inverses of lower-triangular [D, N, N] matrices: one triangular solve
    against the identity (``natgrad.py:477-482``)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return torch.linalg.solve_triangular(M, eye, upper=False)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conversions' products (``natgrad.py:485-491``, HIGHEST precision
    there): plain matmuls, exact fp32 since the package turns TF32 off."""
    return torch.matmul(a, b)


@swap_dimensions
@check_shapes(
    "nat1: [D, N, 1]",
    "nat2: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def natural_to_meanvarsqrt(nat1: torch.Tensor, nat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    var_sqrt_inv = _cholesky(_sym_jitter(-2 * nat2))
    var_sqrt = _inverse_lower_triangular(var_sqrt_inv)
    S = _mm(var_sqrt.mT, var_sqrt)
    mu = _mm(S, nat1)
    # S = L L^T is needed, not L^T L: another Cholesky
    return mu, _cholesky(_sym_jitter(S))


@swap_dimensions
@check_shapes(
    "mu: [D, N, 1]",
    "s_sqrt: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def meanvarsqrt_to_natural(mu: torch.Tensor, s_sqrt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    s_sqrt_inv = _inverse_lower_triangular(s_sqrt)
    s_inv = _mm(s_sqrt_inv.mT, s_sqrt_inv)
    return _mm(s_inv, mu), -0.5 * s_inv


@swap_dimensions
@check_shapes(
    "nat1: [D, N, 1]",
    "nat2: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def natural_to_expectation(nat1: torch.Tensor, nat2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return meanvarsqrt_to_expectation(*natural_to_meanvarsqrt(nat1, nat2, swap=False), swap=False)


@swap_dimensions
@check_shapes(
    "eta1: [D, N, 1]",
    "eta2: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def expectation_to_natural(eta1: torch.Tensor, eta2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return meanvarsqrt_to_natural(*expectation_to_meanvarsqrt(eta1, eta2, swap=False), swap=False)


@swap_dimensions
@check_shapes(
    "eta1: [D, N, 1]",
    "eta2: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def expectation_to_meanvarsqrt(eta1: torch.Tensor, eta2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    var = eta2 - _mm(eta1, eta1.mT)
    return eta1, _cholesky(_sym_jitter(var))


@swap_dimensions
@check_shapes(
    "m: [D, N, 1]",
    "v_sqrt: [D, N, N]",
    "return[0]: [D, N, 1]",
    "return[1]: [D, N, N]",
)
def meanvarsqrt_to_expectation(m: torch.Tensor, v_sqrt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    v = _mm(v_sqrt, v_sqrt.mT)
    return m, v + _mm(m, m.mT)

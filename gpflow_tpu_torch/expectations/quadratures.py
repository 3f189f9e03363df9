"""Gauss-Hermite quadrature fallbacks of the expectations (counterpart of
``gpflow_tpu/expectations/quadratures.py``).

The functions are evaluated at every grid point of every input at once:
Kuf at N * nghp**D points, one K1 launch on a CUDA float32 input."""
from __future__ import annotations

from typing import Any, Callable, Optional, Type

import numpy as np
import torch

from .. import functions as mfn
from .. import kernels
from ..covariances import Kuf
from ..inducing_variables import InducingVariables
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from ..quadrature import mvnquad
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import quadrature_expectation

NoneType: Type[None] = type(None)

register = dispatch.quadrature_expectation.register


def get_eval_func(
    obj: Any,
    inducing_variable: Optional[InducingVariables],
    slice_: Any = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The function of x whose expectation is taken: K(x, Z) [N, M] for a
    kernel with inducing variables, m(x) for a mean function, k(x, x) for a
    kernel alone (``quadratures.py:28-47``); ``slice_`` adds axes to the
    first two."""
    slice_ = ... if slice_ is None else slice_
    if inducing_variable is not None:
        if not isinstance(inducing_variable, InducingVariables) or not isinstance(obj, kernels.Kernel):
            raise TypeError("If `inducing_variable` is supplied, `obj` must be a kernel.")
        return lambda x: Kuf(inducing_variable, obj, x).mT[slice_]
    if isinstance(obj, mfn.MeanFunction):
        return lambda x: obj(x)[slice_]
    if isinstance(obj, kernels.Kernel):
        return lambda x: obj(x, full_cov=False)
    raise NotImplementedError()


@dispatch.quadrature_expectation.register(
    (Gaussian, DiagonalGaussian),
    object,
    (InducingVariables, NoneType),
    object,
    (InducingVariables, NoneType),
)
@check_shapes("p: [N, D]", "inducing_variable1: [M1, D, P]", "inducing_variable2: [M2, D, P]", "return: [N, ...]")
def _quadrature_expectation_gaussian(p, obj1, inducing_variable1, obj2, inducing_variable2, nghp=None):
    """The generic fallback, through a full-covariance Gauss-Hermite grid of
    ``nghp`` (default 100) points a dimension (``quadratures.py:50-93``)."""
    nghp = 100 if nghp is None else nghp

    if obj1 is None:
        raise NotImplementedError("First object cannot be None.")

    if not isinstance(p, DiagonalGaussian):
        cov = p.cov
    else:
        if (
            isinstance(obj1, kernels.Kernel)
            and isinstance(obj2, kernels.Kernel)
            and obj1.on_separate_dims(obj2)
        ):
            eKxz1 = quadrature_expectation(p, (obj1, inducing_variable1), nghp=nghp)
            eKxz2 = quadrature_expectation(p, (obj2, inducing_variable2), nghp=nghp)
            return eKxz1[:, :, None] * eKxz2[:, None, :]
        cov = torch.diag_embed(p.cov)

    if obj2 is None:

        def eval_func(x: torch.Tensor) -> torch.Tensor:
            return get_eval_func(obj1, inducing_variable1)(x)

    else:

        def eval_func(x: torch.Tensor) -> torch.Tensor:
            fn1 = get_eval_func(obj1, inducing_variable1, np.s_[:, :, None])
            fn2 = get_eval_func(obj2, inducing_variable2, np.s_[:, None, :])
            return fn1(x) * fn2(x)

    return mvnquad(eval_func, p.mu, cov, nghp)


@dispatch.quadrature_expectation.register(
    MarkovGaussian, object, (InducingVariables, NoneType), object, (InducingVariables, NoneType)
)
@check_shapes("p: [N, D]", "return: [N, ...]")
def _quadrature_expectation_markov(p, obj1, inducing_variable1, obj2, inducing_variable2, nghp=None):
    """The Markov fallback (``quadratures.py:96-133``): obj1 is taken at
    x_n and obj2 at x_{n+1}; default ``nghp`` 40."""
    nghp = 40 if nghp is None else nghp

    if obj2 is None:

        def eval_func(x: torch.Tensor) -> torch.Tensor:
            return get_eval_func(obj1, inducing_variable1)(x)

        mu, cov = p.mu[:-1], p.cov[0, :-1]
    elif obj1 is None:

        def eval_func(x: torch.Tensor) -> torch.Tensor:
            return get_eval_func(obj2, inducing_variable2)(x)

        mu, cov = p.mu[1:], p.cov[0, 1:]
    else:

        def eval_func(x: torch.Tensor) -> torch.Tensor:
            x1, x2 = torch.chunk(x, 2, dim=1)
            res1 = get_eval_func(obj1, inducing_variable1, np.s_[:, :, None])(x1)
            res2 = get_eval_func(obj2, inducing_variable2, np.s_[:, None, :])(x2)
            return res1 * res2

        mu = torch.cat((p.mu[:-1, :], p.mu[1:, :]), dim=1)  # [N, 2D]
        cov_top = torch.cat((p.cov[0, :-1], p.cov[1, :-1]), dim=2)
        cov_bottom = torch.cat((p.cov[1, :-1].mT, p.cov[0, 1:]), dim=2)
        cov = torch.cat((cov_top, cov_bottom), dim=1)  # [N, 2D, 2D]

    return mvnquad(eval_func, mu, cov, nghp)

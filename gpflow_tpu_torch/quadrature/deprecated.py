"""The older quadrature helpers (counterpart of
``gpflow_tpu/quadrature/deprecated.py``): Gauss-Hermite grids, ``ndiagquad``,
the Monte-Carlo ``ndiag_mc`` and the full-covariance ``mvnquad``.

``ndiag_mc`` draws its standard normals with ``torch.randn`` from the
``generator`` it is given (``MonteCarloLikelihood`` passes its own, seeded
one; inside a trace the draw is an input of the trace, drawn at each
replay, ``_compile.randn``), or from torch's default generator of the
tensors' device. The JAX
package's default draw (a key counter when eager, a key folded from Fmu's
bits under ``jit``) has no bit-for-bit counterpart; a caller that needs
given draws passes ``epsilon``.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._compile import randn
from ..base import array_inputs
from ..config import default_float
from ..utilities.shapes import check_shapes
from .gauss_hermite import NDiagGHQuadrature, gh_points_and_weights

__all__ = ["hermgauss", "mvhermgauss", "mvnquad", "ndiag_mc", "ndiagquad"]


def _numpy_float() -> np.dtype:
    return torch.empty(0, dtype=default_float()).numpy().dtype


@check_shapes(
    "return[0]: [n_quad_points]",
    "return[1]: [n_quad_points]",
)
def hermgauss(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Hermite points and weights in the default float
    (``deprecated.py:49-55``)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x.astype(_numpy_float()), w.astype(_numpy_float())


@check_shapes(
    "return[0]: [n_quad_points, D]",
    "return[1]: [n_quad_points]",
)
def mvhermgauss(H: int, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """The full Gauss-Hermite grid in D dimensions: locations [H**D, D] and
    weights [H**D] (``deprecated.py:62-70``)."""
    gh_x, gh_w = hermgauss(H)
    x = np.array(list(itertools.product(*(gh_x,) * D)))
    w = np.prod(np.array(list(itertools.product(*(gh_w,) * D))), 1)
    return x, w


@array_inputs("Fmu", "Fvar")
@check_shapes(
    "Ys.values(): [N...]",
)
def ndiagquad(
    funcs: Union[Callable[..., torch.Tensor], Iterable[Callable[..., torch.Tensor]]],
    H: int,
    Fmu: Union[torch.Tensor, Sequence[torch.Tensor]],
    Fvar: Union[torch.Tensor, Sequence[torch.Tensor]],
    logspace: bool = False,
    **Ys: torch.Tensor,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """E_q[f] of one or more functions for N independent Gaussians q by
    H-point Gauss-Hermite quadrature per dimension (``deprecated.py:76-129``).

    ``Fmu`` and ``Fvar`` are a tensor (one dimension) or a tuple of Din
    tensors of one shape; each function takes Din positional arguments and
    the ``Ys`` as keywords, and the result has that shape."""
    if isinstance(Fmu, (tuple, list)):
        dim = len(Fmu)
        shape = Fmu[0].shape
        Fmu_stacked = torch.stack(list(Fmu), dim=-1)
        Fvar_stacked = torch.stack(list(Fvar), dim=-1)
    else:
        dim = 1
        shape = Fmu.shape
        Fmu_stacked, Fvar_stacked = Fmu, Fvar

    Fmu_flat = Fmu_stacked.reshape(-1, dim)
    Fvar_flat = Fvar_stacked.reshape(-1, dim)
    Ys_flat = {name: Y.reshape(-1, 1) for name, Y in Ys.items()}

    def wrap(fun: Callable[..., torch.Tensor]) -> Callable[..., torch.Tensor]:
        def new_fun(X: torch.Tensor, **ys: torch.Tensor) -> torch.Tensor:
            Xs = [X[..., i] for i in range(dim)]
            return fun(*Xs, **{k: v[..., 0] for k, v in ys.items()})[..., None]

        return new_fun

    quadrature = NDiagGHQuadrature(dim, H)
    wrapped: Any = wrap(funcs) if callable(funcs) else [wrap(f) for f in funcs]
    if logspace:
        result = quadrature.logspace(wrapped, Fmu_flat, Fvar_flat, **Ys_flat)
    else:
        result = quadrature(wrapped, Fmu_flat, Fvar_flat, **Ys_flat)
    if isinstance(result, list):
        return [r.reshape(shape) for r in result]
    return result.reshape(shape)


@array_inputs("Fmu", "Fvar", "epsilon")
@check_shapes(
    "Fmu: [N, Din]",
    "Fvar: [N, Din]",
    "Ys.values(): [broadcast N, .]",
)
def ndiag_mc(
    funcs: Union[Callable[..., torch.Tensor], Iterable[Callable[..., torch.Tensor]]],
    S: int,
    Fmu: torch.Tensor,
    Fvar: torch.Tensor,
    logspace: bool = False,
    epsilon: Optional[torch.Tensor] = None,
    *,
    generator: Optional[torch.Generator] = None,
    **Ys: torch.Tensor,
) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Monte-Carlo estimates of E_q[f] from S draws per Gaussian
    (``deprecated.py:137-172``): ``epsilon`` [S, N, Din] standard normals,
    or, if None, drawn on Fmu's device from ``generator``. With
    ``logspace`` the estimate is log mean exp f."""
    N, D = Fmu.shape[0], Fmu.shape[-1]
    if epsilon is None:
        epsilon = randn((S, N, D), generator=generator, dtype=Fmu.dtype, device=Fmu.device)
    # a variance that rounding left at or below zero is clamped to zero;
    # double where, so the clamped branch has a zero (not a NaN) gradient
    positive = Fvar > 0
    safe_var = torch.where(positive, Fvar, 1.0)
    std = torch.where(positive, torch.sqrt(safe_var), 0.0)
    mc_x = Fmu[None, :, :] + std[None, :, :] * epsilon
    mc_Xr = mc_x.reshape(S * N, D)
    Ys_r = {name: Y.repeat(S, 1) for name, Y in Ys.items()}

    def eval_func(func: Callable[..., torch.Tensor]) -> torch.Tensor:
        feval = func(mc_Xr, **Ys_r).reshape(S, N, -1)
        if logspace:
            return torch.logsumexp(feval, dim=0) - math.log(S)
        return torch.mean(feval, dim=0)

    if callable(funcs):
        return eval_func(funcs)
    return [eval_func(f) for f in funcs]


@array_inputs("means", "covs")
@check_shapes(
    "means: [N, Din]",
    "covs: [N, Din, Din]",
)
def mvnquad(
    func: Callable[[torch.Tensor], torch.Tensor],
    means: torch.Tensor,
    covs: torch.Tensor,
    H: int,
    Din: Optional[int] = None,
    Dout: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """E_q[func] for N full-covariance Gaussians q by an H**Din-point
    Gauss-Hermite grid rotated by each covariance's Cholesky factor
    (``deprecated.py:179-210``): means [N, Din], covs [N, Din, Din] ->
    [N, *Dout]."""
    if Din is None:
        Din = means.shape[1]
    xn, wn = gh_points_and_weights(H)
    grid = np.array(np.meshgrid(*(xn,) * Din)).reshape(Din, -1).T  # [H**Din, Din]
    wgrid = np.prod(np.array(np.meshgrid(*(wn,) * Din)).reshape(Din, -1).T, axis=1)
    grid = torch.as_tensor(grid, dtype=means.dtype, device=means.device)
    wgrid = torch.as_tensor(wgrid, dtype=means.dtype, device=means.device)

    chol = torch.linalg.cholesky(covs)  # [N, Din, Din]
    Xall = means[:, None, :] + torch.einsum("nij,qj->nqi", chol, grid)  # [N, H**Din, Din]
    N = means.shape[0]
    fevals = func(Xall.reshape(-1, Din))
    if Dout is None:
        Dout = tuple(fevals.shape[1:])
    fX = fevals.reshape((N, grid.shape[0]) + tuple(Dout))
    wr = wgrid.reshape((1, grid.shape[0]) + (1,) * len(Dout))
    return torch.sum(fX * wr, dim=1)

"""N-dimensional diagonal Gauss-Hermite quadrature (counterpart of
``gpflow_tpu/quadrature/gauss_hermite.py``). The points and weights come from
numpy's ``hermgauss``, once, at construction."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from .._compile import outside_trace
from ..config import default_device
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import GaussianQuadrature

__all__ = [
    "DeviceGrid",
    "NDiagGHQuadrature",
    "canonical_device",
    "gh_points_and_weights",
    "list_to_flat_grid",
    "ndgh_points_and_weights",
    "repeat_as_list",
    "reshape_Z_dZ",
]


@check_shapes(
    "xs[all]: [.]",
    "return: [N_product, D]",
)
def list_to_flat_grid(xs: Sequence[np.ndarray]) -> np.ndarray:
    """The [N1 * ... * Nd, d] grid of all combinations of d rank-1 arrays,
    in 'xy' meshgrid order (``gauss_hermite.py:28-32``)."""
    return np.reshape(np.stack(np.meshgrid(*xs), axis=-1), (-1, len(xs)))


@check_shapes(
    "zs[all]: [.]",
    "dzs[all]: [.]",
    "return[0]: [N_product, D]",
    "return[1]: [N_product, 1]",
)
def reshape_Z_dZ(zs: Sequence[np.ndarray], dzs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Grid points Z [N_product, d] and product weights dZ [N_product, 1]
    from per-dimension points and weights (``gauss_hermite.py:41-49``)."""
    Z = list_to_flat_grid(zs)
    dZ = np.prod(list_to_flat_grid(dzs), axis=-1, keepdims=True)
    return Z, dZ


@check_shapes(
    "x: [any...]",
    "return[all]: [any...]",
)
def repeat_as_list(x: np.ndarray, n: int) -> List[np.ndarray]:
    """A list of ``n`` references to ``x`` (``gauss_hermite.py:56-58``)."""
    return [x for _ in range(n)]


@check_shapes(
    "return[0]: [N]",
    "return[1]: [N]",
)
def gh_points_and_weights(n_gh: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hermite-Gauss points z (times sqrt(2)) and weights dz (over sqrt(pi)),
    so that E_{N(mu, s^2)}[f] ~= sum_i dz_i f(mu + s z_i)
    (``gauss_hermite.py:65-74``)."""
    z, dz = np.polynomial.hermite.hermgauss(n_gh)
    return z * np.sqrt(2.0), dz / np.sqrt(np.pi)


@check_shapes(
    "return[0]: [N_quad, D]",
    "return[1]: [N_quad, 1]",
)
def ndgh_points_and_weights(dim: int, n_gh: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Cartesian-product grid over ``dim`` dimensions: Z [n_gh**dim, dim]
    and dZ [n_gh**dim, 1] (``gauss_hermite.py:81-89``)."""
    z, dz = gh_points_and_weights(n_gh)
    return reshape_Z_dZ(repeat_as_list(z, dim), repeat_as_list(dz, dim))


def canonical_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a cache key: a bare "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceGrid:
    """Host arrays of a quadrature grid, placed on ``config.default_device()``
    in float64 when the grid is built and cast on the device to the type of
    each use, once: a training step makes no host-to-device copy of them."""

    def __init__(self, *arrays: np.ndarray) -> None:
        self._arrays = arrays
        self._grids: Dict[Tuple[torch.device, torch.dtype], Tuple[torch.Tensor, ...]] = {}
        self.grid(default_device(), torch.float64)

    def grid(self, device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
        """The arrays on ``device`` in ``dtype``: cast from a float64 copy
        already on that device where there is one, else copied from the
        host."""
        device = canonical_device(device)
        key = (device, dtype)
        if key not in self._grids:
            with outside_trace():  # filled inside a trace too, the cache holds real tensors
                source = self._grids.get((device, torch.float64))
                if source is None:
                    source = tuple(torch.as_tensor(a, dtype=torch.float64, device=device) for a in self._arrays)
                    self._grids[(device, torch.float64)] = source
                self._grids[key] = tuple(t.to(dtype) for t in source)
        return self._grids[key]


class NDiagGHQuadrature(GaussianQuadrature, DeviceGrid):
    """Gauss-Hermite quadrature for diagonal Gaussians of dimension ``dim``
    (``gauss_hermite.py:92-127``), its grid a ``DeviceGrid``."""

    def __init__(self, dim: int, n_gh: int) -> None:
        self.dim = dim
        self.n_gh = n_gh
        self.n_gh_total = n_gh ** dim
        self.Z, self.dZ = ndgh_points_and_weights(dim, n_gh)
        DeviceGrid.__init__(self, self.Z, self.dZ)

    def __eq__(self, other: object) -> bool:
        """Equal where the dimension and the degree are: the grid is a
        function of the two, so a trace (``_compile.jit``) keyed by one
        model's quadrature serves another model of the same structure."""
        return type(other) is type(self) and (other.dim, other.n_gh) == (self.dim, self.n_gh)

    def __hash__(self) -> int:
        return hash((type(self), self.dim, self.n_gh))

    @inherit_check_shapes
    def _build_X_W(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mean, var [b1, ..., bN, dim] -> X [n_gh_total, b1, ..., bN, dim]
        and W [n_gh_total, 1, ..., 1]."""
        batch_ndim = mean.ndim - 1
        Z, dZ = self.grid(mean.device, mean.dtype)
        Z = Z.reshape((self.n_gh_total,) + (1,) * batch_ndim + (self.dim,))
        W = dZ.reshape((self.n_gh_total,) + (1,) * batch_ndim + (1,))
        # A variance that rounding left at or below zero is clamped to zero,
        # which evaluates the integrand at the mean. Double where: with
        # sqrt(clamp(var, 0)) alone the gradient is NaN (inf * 0) exactly
        # where the clamp engages, so the clamped branch never sees var.
        positive = var > 0
        safe_var = torch.where(positive, var, 1.0)
        stddev = torch.where(positive, torch.sqrt(safe_var), 0.0)
        X = mean[None] + stddev[None] * Z
        return X, W

"""Tensor helpers (counterpart of ``gpflow_tpu/utilities/ops.py``)."""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..base import array_inputs
from ..config import as_torch_dtype, default_device, default_float
from .shapes import check_shapes

__all__ = [
    "broadcasting_elementwise",
    "difference_matrix",
    "eye",
    "leading_transpose",
    "pca_reduce",
    "square_distance",
]


@check_shapes(
    "value: []",
    "return: [N, N]",
)
def eye(num: int, value: Union[torch.Tensor, float] = 1.0, dtype: Any = None) -> torch.Tensor:
    """value * I_num (``gpflow_tpu/utilities/ops.py:28-34``), in ``dtype``
    (default: ``default_float()``), on ``value``'s device if it is a tensor,
    else on ``config.default_device()``."""
    dtype = as_torch_dtype(dtype) if dtype is not None else default_float()
    if isinstance(value, torch.Tensor):
        return value.to(dtype) * torch.eye(num, dtype=dtype, device=value.device)
    return value * torch.eye(num, dtype=dtype, device=default_device())


@array_inputs("a", "b")
@check_shapes(
    "a: [a_shape...]",
    "b: [b_shape...]",
    "return: [a_shape..., b_shape...]",
)
def broadcasting_elementwise(
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``op`` applied to every pair: result[i..., j...] = op(a[i...], b[j...])
    (``gpflow_tpu/utilities/ops.py:62-76``)."""
    flatres = op(a.reshape(-1, 1), b.reshape(1, -1))
    return flatres.reshape(a.shape + b.shape)


@array_inputs("X", "X2")
@check_shapes(
    "X: [batch..., N, D]",
    "X2: [batch2..., N2, D]",
    "return: [batch..., N, batch2..., N2] if X2 is not None",
    "return: [batch..., N, N] if X2 is None",
)
def square_distance(X: torch.Tensor, X2: Optional[torch.Tensor]) -> torch.Tensor:
    """Squared pairwise distance ||x - x2||^2 by the norm expansion
    (``gpflow_tpu/utilities/ops.py:84-102``).

    X: [..., N, D], X2: [..., M, D] or None -> [..., N, ..., M] (or
    [..., N, N]). As in the JAX package, the leading dims of X and X2 cross,
    and the result is not clamped at zero. With X2 None on the card the
    diagonal is exactly 0.
    """
    if X2 is None:
        Xs = torch.sum(torch.square(X), dim=-1, keepdim=True)
        dist = -2.0 * torch.matmul(X, X.mT)
        dist += Xs + Xs.mT
        if dist.is_cuda:
            # ||x - x||^2 is 0, but on the card cuBLAS's product and the row
            # sums round apart by ~eps |x|^2, which the kernels of
            # r = sqrt(d2) turn into ~1e-8 of the diagonal in float64
            dist.diagonal(dim1=-2, dim2=-1).zero_()
        return dist
    Xs = torch.sum(torch.square(X), dim=-1)  # [batch..., N]
    X2s = torch.sum(torch.square(X2), dim=-1)  # [batch2..., M]
    dist = -2.0 * torch.tensordot(X, X2, dims=([-1], [-1]))  # [batch..., N, batch2..., M]
    dist += Xs.reshape(Xs.shape + (1,) * X2s.ndim) + X2s
    return dist


@array_inputs("X", "X2")
@check_shapes(
    "X: [batch..., N, D]",
    "X2: [batch2..., N2, D]",
    "return: [batch..., N, batch2..., N2, D] if X2 is not None",
    "return: [batch..., N, N, D] if X2 is None",
)
def difference_matrix(X: torch.Tensor, X2: Optional[torch.Tensor]) -> torch.Tensor:
    """Pairwise differences X[..., n, :] - X2[..., m, :]
    (``gpflow_tpu/utilities/ops.py:111-124``): [batch..., N, D] and
    [batch2..., M, D] give [batch..., N, batch2..., M, D], the leading dims
    crossing as in ``square_distance``; with X2 None, [batch..., N, N, D]."""
    if X2 is None:
        return X[..., :, None, :] - X[..., None, :, :]
    Xf = X.reshape(-1, X.shape[-1])
    X2f = X2.reshape(-1, X2.shape[-1])
    diff = Xf[:, None, :] - X2f[None, :, :]
    return diff.reshape(X.shape[:-1] + X2.shape[:-1] + (X.shape[-1],))


@array_inputs("tensor")
@check_shapes(
    "tensor: [any...]",
    "return: [transposed_any...]",
)
def leading_transpose(tensor: torch.Tensor, perm: Sequence, leading_dim: int = 0) -> torch.Tensor:
    """Transposes ``tensor`` with its leading dims left in place
    (``gpflow_tpu/utilities/ops.py:44-66``): ``perm`` holds ``...`` for the
    leading dims and indices, negative ones counted from the end, for the
    others, e.g. ``[..., -1, -2]``. ``leading_dim`` is accepted for the
    signature and never changes the result, as in the JAX package."""
    del leading_dim
    perm = list(perm)
    idx = perm.index(...)
    rank = tensor.ndim
    lead = list(range(rank - (len(perm) - 1)))
    pre = [p % rank for p in perm[:idx]]
    post = [p % rank for p in perm[idx + 1:]]
    return tensor.permute(pre + lead + post)


@check_shapes(
    "X: [N, D]",
    "latent_dim: []",
    "return: [N, Q]",
)
def pca_reduce(X: Any, latent_dim: int) -> torch.Tensor:
    """X [N, D] projected onto its ``latent_dim`` principal directions
    (``gpflow_tpu/utilities/ops.py:132-143``), to start a GPLVM's latent X.
    It is computed on the host by numpy's ``eigh`` in float64, as the JAX
    package computes it, so that the eigenvectors' signs are the same; the
    result takes X's float type and device (a numpy X: the defaults)."""
    if latent_dim > X.shape[1]:
        raise ValueError("Cannot have more latent dimensions than observed")
    if isinstance(X, torch.Tensor):
        dtype, device = X.dtype, X.device
        X_np = X.detach().cpu().numpy().astype(np.float64)
    else:
        dtype, device = default_float(), default_device()
        X_np = np.asarray(X, dtype=np.float64)
    X_centered = X_np - X_np.mean(axis=0, keepdims=True)
    _, evecs = np.linalg.eigh(np.atleast_2d(np.cov(X_centered.T)))
    return torch.tensor(X_centered @ evecs[:, -latent_dim:], dtype=dtype, device=device)

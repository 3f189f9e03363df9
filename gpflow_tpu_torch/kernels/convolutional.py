"""Convolutional GP kernel (counterpart of ``gpflow_tpu/kernels/convolutional.py``).

f(x) = sum_p w_p g(x^[p]) over the P patches of an image, with a base kernel
g over patches (van der Wilk et al. 2017). The patches are gathered with
static index arrays, per colour channel, in the JAX package's order.
``K(X)`` flattens the patches to [N P, S] and calls the base kernel once on
2-D inputs, so a stationary base kernel reaches K1 on the card; ``K(X, X2)``
and ``K_diag`` keep the JAX package's batched base-kernel call, the plain
PyTorch path.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..base import Parameter, input_to_tensor
from ..config import default_float
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import Kernel

__all__ = ["Convolutional"]


class Convolutional(Kernel):
    """Sum-of-patch-responses image kernel: k(x, x') = sum_{p, q} w_p w_q
    g(x^[p], x'^[q]) / P^2 (``convolutional.py:18-114``)."""

    @check_shapes(
        "weights: [P]",
    )
    def __init__(
        self,
        base_kernel: Kernel,
        image_shape: Sequence[int],
        patch_shape: Sequence[int],
        weights: Optional[Any] = None,
        colour_channels: int = 1,
    ) -> None:
        super().__init__()
        self.image_shape = tuple(int(i) for i in image_shape)
        self.patch_shape = tuple(int(i) for i in patch_shape)
        self.base_kernel = base_kernel
        self.colour_channels = int(colour_channels)
        self.weights = Parameter(
            torch.ones(self.num_patches, dtype=default_float()) if weights is None else weights,
            name="weights",
        )

    def _patch_index(self, device: torch.device) -> torch.Tensor:
        """[ow oh, pw ph] flat pixel indices of every patch, built on
        ``device`` from the shapes alone (an index copied from the host would
        synchronise it with a CUDA device)."""
        W, H = self.image_shape
        pw, ph = self.patch_shape
        ow, oh = W - pw + 1, H - ph + 1
        i0, j0, di, dj = (torch.arange(n, device=device) for n in (ow, oh, pw, ph))
        rows = i0[:, None, None, None] + di[None, None, :, None]  # [ow, 1, pw, 1]
        cols = j0[None, :, None, None] + dj[None, None, None, :]  # [1, oh, 1, ph]
        return (rows * H + cols).reshape(ow * oh, pw * ph)

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N, P, S]",
    )
    def get_patches(self, X: torch.Tensor) -> torch.Tensor:
        """[batch..., N, W H C] images -> [batch..., N, C ow oh, S] patches,
        channel-major as ``convolutional.py:48-73`` takes them, in the
        weights' dtype (the JAX package casts to the default float)."""
        batch, N = X.shape[:-2], X.shape[-2]
        C = self.colour_channels
        W, H = self.image_shape
        # [n, W H C] -> [n, C, W H] -> [n C, W H]
        imgs = X.reshape(-1, W * H, C).transpose(-1, -2).reshape(-1, W * H)
        index = self._patch_index(X.device)  # [ow oh, S]
        patches = imgs[:, index]  # [n C, ow oh, S]
        out = patches.reshape(batch + (N, self.num_patches, index.shape[-1]))
        return out.to(self.weights.dtype)

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        Xp = self.get_patches(X)  # [batch..., N, P, S]
        w = self.weights.value
        W2 = w[:, None] * w[None, :]  # [P, P]
        batch = Xp.shape[:-3]
        rank = len(batch)
        N, P, S = Xp.shape[-3:]
        if X2 is None:
            bigK = self.base_kernel.K(Xp.reshape(batch + (N * P, S)))  # [batch..., N P, N P]
            bigK = bigK.reshape(batch + (N, P, N, P))
            W2r = W2.reshape((1,) * rank + (1, P, 1, P))
            return torch.sum(bigK * W2r, dim=(rank + 1, rank + 3)) / self.num_patches ** 2.0
        Xp2 = self.get_patches(X2)  # [batch2..., N2, P, S]
        rank2 = Xp2.ndim - 3
        bigK = self.base_kernel.K(Xp, Xp2)  # [batch..., N, P, batch2..., N2, P]
        W2r = W2.reshape((1,) * rank + (1, P) + (1,) * rank2 + (1, P))
        return torch.sum(bigK * W2r, dim=(rank + 1, rank + rank2 + 3)) / self.num_patches ** 2.0

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        Xp = self.get_patches(X)  # [batch..., N, P, S]
        rank = Xp.ndim - 3
        P = Xp.shape[-2]
        w = self.weights.value
        W2r = (w[:, None] * w[None, :]).reshape((1,) * rank + (1, P, P))
        bigK = self.base_kernel.K(Xp)  # [batch..., N, P, P]
        return torch.sum(bigK * W2r, dim=(rank + 1, rank + 2)) / self.num_patches ** 2.0

    @property
    def patch_len(self) -> int:
        return int(np.prod(self.patch_shape))

    @property
    def num_patches(self) -> int:
        return (
            (self.image_shape[0] - self.patch_shape[0] + 1)
            * (self.image_shape[1] - self.patch_shape[1] + 1)
            * self.colour_channels
        )

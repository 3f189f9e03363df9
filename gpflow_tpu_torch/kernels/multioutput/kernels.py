"""Multioutput kernels (counterpart of
``gpflow_tpu/kernels/multioutput/kernels.py``).

Shapes, for P outputs and L latent GPs:
  K(X, X2, full_output_cov=True)  -> [batch..., N, P, batch2..., N2, P]
  K(X, X2, full_output_cov=False) -> [P, batch..., N, batch2..., N2]
  K_diag(X, full_output_cov=True)  -> [batch..., N, P, P]
  K_diag(X, full_output_cov=False) -> [batch..., N, P]
Calling a multioutput kernel defaults to full_cov=False and
full_output_cov=True, unlike a single-output kernel. Each latent kernel's
``K`` is the single-output one, so a stationary latent on a CUDA float32
input reaches kernel K1.
"""
from __future__ import annotations

import abc
from typing import Any, Optional, Sequence, Tuple

import torch

from ...base import Parameter, input_to_tensor
from ...utilities.shapes import check_shapes, inherit_check_shapes
from ..base import Combination, Kernel

__all__ = [
    "IndependentLatent",
    "LinearCoregionalization",
    "MultioutputKernel",
    "SeparateIndependent",
    "SharedIndependent",
]


def _tile_output_diag(K: torch.Tensor, P: int, rank: int) -> torch.Tensor:
    """[batch..., N, (batch2...,) N2] -> [batch..., N, P, (batch2...,) N2, P]
    with the outputs on an identity (block-diagonal outputs)."""
    Kexp = K.unsqueeze(rank).unsqueeze(-1)
    eye = torch.eye(P, dtype=K.dtype, device=K.device)
    return Kexp * eye.reshape((1,) * rank + (P,) + (1,) * (K.ndim - rank) + (P,))


class MultioutputKernel(Kernel):
    """Base class of the multioutput kernels (``kernels.py:41-104``)."""

    @property
    @abc.abstractmethod
    def num_latent_gps(self) -> int:
        raise NotImplementedError

    @property
    @abc.abstractmethod
    def latent_kernels(self) -> Tuple[Kernel, ...]:
        raise NotImplementedError

    @abc.abstractmethod
    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, P, batch2..., N2, P] if full_output_cov and (X2 is not None)",
        "return: [P, batch..., N, batch2..., N2] if not full_output_cov and (X2 is not None)",
        "return: [batch..., N, P, N, P] if full_output_cov and (X2 is None)",
        "return: [P, batch..., N, N] if not full_output_cov and (X2 is None)",
    )
    def K(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None, full_output_cov: bool = True
    ) -> torch.Tensor:
        raise NotImplementedError

    @abc.abstractmethod
    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N, P, P] if full_output_cov",
        "return: [batch..., N, P] if not full_output_cov",
    )
    def K_diag(self, X: torch.Tensor, full_output_cov: bool = True) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, P, batch2..., N2, P] if full_cov and full_output_cov and (X2 is not None)",
        "return: [P, batch..., N, batch2..., N2] if full_cov and (not full_output_cov) and (X2 is not None)",
        "return: [batch..., N, P, N, P] if full_cov and full_output_cov and (X2 is None)",
        "return: [P, batch..., N, N] if full_cov and (not full_output_cov) and (X2 is None)",
        "return: [batch..., N, P, P] if (not full_cov) and full_output_cov and (X2 is None)",
        "return: [batch..., N, P] if (not full_cov) and (not full_output_cov) and (X2 is None)",
    )
    def forward(
        self,
        X: torch.Tensor,
        X2: Optional[torch.Tensor] = None,
        *,
        full_cov: bool = False,
        full_output_cov: bool = True,
        presliced: bool = False,
    ) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        if not presliced:
            X, X2 = self.slice(X, X2)
        if not full_cov and X2 is not None:
            raise ValueError("Ambiguous inputs: passing in `X2` is not compatible with `full_cov=False`.")
        if not full_cov:
            return self.K_diag(X, full_output_cov=full_output_cov)
        return self.K(X, X2, full_output_cov=full_output_cov)


class SharedIndependent(MultioutputKernel):
    """One kernel, ``.kernel``, for each of P independent outputs
    (``kernels.py:107-140``)."""

    def __init__(self, kernel: Kernel, output_dim: int) -> None:
        super().__init__()
        self.kernel = kernel
        self.output_dim = output_dim

    @property
    def num_latent_gps(self) -> int:
        return self.output_dim

    @property
    def latent_kernels(self) -> Tuple[Kernel, ...]:
        return (self.kernel,)

    @inherit_check_shapes
    def K(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None, full_output_cov: bool = True
    ) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        K = self.kernel.K(X, X2)
        if full_output_cov:
            return _tile_output_diag(K, self.output_dim, X.ndim - 1)
        return K.unsqueeze(0).expand((self.output_dim,) + K.shape)

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor, full_output_cov: bool = True) -> torch.Tensor:
        X = input_to_tensor(self, X)
        K = self.kernel.K_diag(X)  # [batch..., N]
        Ks = K.unsqueeze(-1).expand(K.shape + (self.output_dim,))
        if full_output_cov:
            return Ks[..., :, None] * torch.eye(self.output_dim, dtype=K.dtype, device=K.device)
        return Ks


class SeparateIndependent(MultioutputKernel, Combination):
    """One kernel per independent output, held in the ``nn.ModuleList``
    ``kernels`` (``kernels.py:143-181``)."""

    def __init__(self, kernels: Sequence[Kernel], name: Optional[str] = None) -> None:
        Combination.__init__(self, kernels=kernels, name=name)

    @property
    def num_latent_gps(self) -> int:
        return len(self.kernels)

    @property
    def latent_kernels(self) -> Tuple[Kernel, ...]:
        return tuple(self.kernels)

    @inherit_check_shapes
    def K(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None, full_output_cov: bool = True
    ) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        Ks = torch.stack([k.K(X, X2) for k in self.kernels], dim=0)  # [P, ...]
        if not full_output_cov:
            return Ks
        rank = X.ndim - 1
        P = len(self.kernels)
        Kexp = torch.movedim(Ks, 0, rank).unsqueeze(-1)  # [batch..., N, P, (batch2...,) N2, 1]
        eye = torch.eye(P, dtype=Ks.dtype, device=Ks.device)
        return Kexp * eye.reshape((1,) * rank + (P,) + (1,) * (Ks.ndim - 1 - rank) + (P,))

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor, full_output_cov: bool = False) -> torch.Tensor:
        X = input_to_tensor(self, X)
        stacked = torch.stack([k.K_diag(X) for k in self.kernels], dim=-1)  # [batch..., N, P]
        if full_output_cov:
            return stacked[..., :, None] * torch.eye(len(self.kernels), dtype=stacked.dtype, device=stacked.device)
        return stacked


class IndependentLatent(MultioutputKernel):
    """Kernels built from independent latent GPs, which give the
    block-diagonal latent covariance ``Kgg`` [L, batch..., N, batch2..., N2]
    (``kernels.py:184-196``)."""

    @abc.abstractmethod
    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [L, batch..., N, batch2..., N2]",
    )
    def Kgg(self, X: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class LinearCoregionalization(IndependentLatent, Combination):
    """f = W g: L latent GPs, the ``nn.ModuleList`` ``kernels``, mixed into P
    outputs by the Parameter W [P, L] (``kernels.py:199-250``)."""

    def __init__(self, kernels: Sequence[Kernel], W: Any, name: Optional[str] = None) -> None:
        Combination.__init__(self, kernels=kernels, name=name)
        self.W = Parameter(W, name="W")

    @property
    def num_latent_gps(self) -> int:
        return self.W.shape[-1]

    @property
    def latent_kernels(self) -> Tuple[Kernel, ...]:
        return tuple(self.kernels)

    @inherit_check_shapes
    def Kgg(self, X: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        return torch.stack([k.K(X, X2) for k in self.kernels], dim=0)

    @inherit_check_shapes
    def K(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None, full_output_cov: bool = True
    ) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        Kxx = self.Kgg(X, X2)  # [L, batch..., N, (batch2...,) N2]
        W = self.W.value  # [P, L]
        P, L = W.shape
        W_broadcast = W.reshape((P, L) + (1,) * (Kxx.ndim - 1))
        KxxW = Kxx[None, ...] * W_broadcast  # [P, L, batch..., N, (batch2...,) N2]
        if not full_output_cov:
            return torch.sum(W_broadcast * KxxW, dim=1)  # [P, batch..., N, (batch2...,) N2]
        WKxxW = torch.tensordot(W, KxxW, dims=([1], [1]))  # [P, P, batch..., N, (batch2...,) N2]
        rank = X.ndim - 1
        if X2 is None:
            perm = tuple(range(2, 2 + rank)) + (0, 2 + rank, 1)  # [batch..., N, P, N, P]
        else:
            rank2 = X2.ndim - 1
            perm = tuple(range(2, 2 + rank)) + (0,) + tuple(2 + rank + i for i in range(rank2)) + (1,)
        return WKxxW.permute(perm)

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor, full_output_cov: bool = True) -> torch.Tensor:
        X = input_to_tensor(self, X)
        K = torch.stack([k.K_diag(X) for k in self.kernels], dim=-1)  # [batch..., N, L]
        W = self.W.value
        if full_output_cov:
            return torch.einsum("...l,pl,ql->...pq", K, W, W)  # [batch..., N, P, P]
        return torch.matmul(K, (W ** 2.0).mT)  # [batch..., N, P]

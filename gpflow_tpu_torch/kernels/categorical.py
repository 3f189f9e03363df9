"""Categorical latent-space kernel wrapper (counterpart of
``gpflow_tpu/kernels/categorical.py``)."""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..base import Parameter, input_to_tensor
from ..config import default_int
from ..utilities.misc import set_trainable
from ..utilities.shapes import inherit_check_shapes
from .base import Kernel

__all__ = ["Categorical"]


def latent_from_labels(Z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The rows of Z [num_labels, label_dim] at integer labels [batch...]
    (``categorical.py:20-31``), with no host read: a label whose integer
    cast lies outside [0, num_labels) gives a NaN row, as in the JAX package.
    A NaN label gives a NaN row too; the JAX package's cast maps NaN to 0 on
    XLA's CPU, where torch's cast gives no defined integer."""
    indices = labels.to(default_int())
    num = Z.shape[0]
    valid = torch.isfinite(labels) & (indices >= 0) & (indices < num)
    out = Z.index_select(0, torch.clamp(indices, 0, num - 1).reshape(-1))
    out = out.reshape(labels.shape + Z.shape[1:])
    return torch.where(valid[..., None], out, torch.full_like(out, float("nan")))


def _concat_inputs_with_latents(Z: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """X with its last (label) column replaced by the labels' latent values
    (``categorical.py:34-38``)."""
    latent_values = latent_from_labels(Z, X[..., -1])
    return torch.cat([X[..., :-1], latent_values], dim=-1)


class Categorical(Kernel):
    """Wraps a non-categorical kernel and a frozen categorical kernel, whose
    product acts on the inputs with the last column's integer labels
    replaced by learned latent values (``categorical.py:41-84``). Like the
    JAX package, ``K`` and ``K_diag`` call the product's ``K`` and
    ``K_diag``, which do not cut the inputs to each term's active dims."""

    def __init__(
        self,
        non_categorical_kernel: Kernel,
        categorical_kernel: Kernel,
        num_labels: int,
        *args: Any,
        **kwargs: Any,
    ) -> None:
        super().__init__(*args, **kwargs)  # an nn.Module takes attributes only once initialised
        set_trainable(categorical_kernel, False)
        self.wrapped_kernel = non_categorical_kernel * categorical_kernel
        label_dim = 1
        # the num_labels - 1 differences of the latent values, drawn from
        # numpy's global state as the JAX package draws them
        self._Z_deltas = Parameter(
            np.random.random((num_labels - 1, label_dim)) * categorical_kernel.lengthscales.numpy() * 10,
            name="Z_deltas",
        )

    @property
    def Z(self) -> torch.Tensor:
        """Z[0] = 0, Z[k] = sum(deltas[:k]): [num_labels, 1]."""
        deltas = self._Z_deltas.value.reshape(-1)
        z = torch.cat([torch.zeros(1, dtype=deltas.dtype, device=deltas.device), deltas])
        return torch.cumsum(z, dim=0)[:, None]

    def _concat_inputs_with_latents(self, X: torch.Tensor) -> torch.Tensor:
        return _concat_inputs_with_latents(self.Z, X)

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        return self.wrapped_kernel.K(
            self._concat_inputs_with_latents(X),
            self._concat_inputs_with_latents(X2) if X2 is not None else None,
        )

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        return self.wrapped_kernel.K_diag(self._concat_inputs_with_latents(X))

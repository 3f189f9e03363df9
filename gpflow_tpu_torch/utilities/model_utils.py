"""Model helpers (counterpart of ``gpflow_tpu/utilities/model_utils.py``)."""
from __future__ import annotations

from typing import Any, Callable

import torch

from .shapes import check_shapes

__all__ = ["add_likelihood_noise_cov", "add_noise_cov", "assert_params_false"]


def assert_params_false(called_method: Callable[..., Any], **kwargs: bool) -> None:
    """Raises NotImplementedError naming every keyword argument that is True."""
    errors_str = ", ".join(f"{param}={value}" for param, value in kwargs.items() if value)
    if errors_str:
        raise NotImplementedError(
            f"{called_method.__qualname__} does not currently support: {errors_str}"
        )


@check_shapes(
    "K: [batch..., N, N]",
    "likelihood_variance: [broadcast batch..., broadcast N]",
    "return: [batch..., N, N]",
)
def add_noise_cov(K: torch.Tensor, likelihood_variance: torch.Tensor) -> torch.Tensor:
    """K + sigma^2 I for K [batch..., N, N] and a variance that broadcasts to
    [batch..., N]."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + torch.as_tensor(likelihood_variance) * eye


@check_shapes(
    "K: [batch..., N, N]",
    "X: [batch..., N, D]",
    "return: [batch..., N, N]",
)
def add_likelihood_noise_cov(K: torch.Tensor, likelihood: Any, X: torch.Tensor) -> torch.Tensor:
    """K + diag(likelihood.variance_at(X)), batched over the leading dims:
    K [batch..., N, N] and X [batch..., N, D] give a variance [batch..., N]
    that scales the identity per batch element."""
    variance = likelihood.variance_at(X).squeeze(-1)  # [batch..., N]
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + variance[..., None] * eye

"""Fused stationary covariance matrices: kernel K1, its plain version, and the
routing rule (counterpart of ``gpflow_tpu/ops/pallas_distance.py``; the
module and its public names keep the JAX package's, where K1 is a Pallas
kernel).

``K[i, j] = variance * h(||xs_i - zs_j||^2)`` for inputs already divided by
the lengthscales, h one of ``PALLAS_FAMILIES``:

* on a CUDA tensor in float32 or bfloat16, K1 computes it: a CUDA C++
  kernel for Hopper (``gpflow_tpu_torch/csrc/stationary_k1.cu``), built with
  nvcc on first use and loaded with ctypes;
* on a CPU tensor, the plain PyTorch version ``stationary_forward_plain``
  computes the same function.

float64 never reaches K1 (``pallas_available``), as in the JAX package: the
kernel computes in float32. A CUDA request that K1 cannot take raises; there
is no fallback to the plain version on the card.

K1 is forward-only for now: a CUDA request that needs a gradient raises
NotImplementedError.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from ..utilities.ops import square_distance
from .cuda_build import load_library

__all__ = [
    "PALLAS_FAMILIES",
    "k1_library",
    "launch_counts",
    "pallas_available",
    "stationary_forward",
    "stationary_forward_cuda",
    "stationary_forward_plain",
    "stationary_kernel_matrix",
]

PALLAS_FAMILIES = ("rbf", "exponential", "matern12", "matern32", "matern52", "rq")
_FAMILY_CODES = {f: i for i, f in enumerate(PALLAS_FAMILIES)}  # as in stationary_k1.cu
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_TILE_N, _TILE_M = 64, 128  # output tile of one K1 block (stationary_k1.cu)

#: Launches of each hand-written kernel in this process; a wrapper adds one
#: where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"K1": 0}


def pallas_available(X: torch.Tensor) -> bool:
    """True where K1 serves ``X``: a CUDA tensor in float32 or bfloat16
    (``gpflow_tpu/ops/pallas_distance.py:57-75``, without its override)."""
    return X.is_cuda and X.dtype in _KERNEL_DTYPES


def _tail_value(family: str, d2: torch.Tensor, alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h(d2), with the sqrt clipped at 1e-36 like ``pallas_distance.py:78-98``."""
    if family == "rbf":
        return torch.exp(-0.5 * d2)
    if family == "rq":
        return torch.exp(-alpha * torch.log1p(0.5 * d2 / alpha))
    r = torch.sqrt(torch.clamp(d2, min=1e-36))
    if family == "exponential":
        return torch.exp(-0.5 * r)
    if family == "matern12":
        return torch.exp(-r)
    if family == "matern32":
        s = math.sqrt(3.0)
        return (1.0 + s * r) * torch.exp(-s * r)
    if family == "matern52":
        s = math.sqrt(5.0)
        return (1.0 + s * r + (5.0 / 3.0) * d2) * torch.exp(-s * r)
    raise ValueError(f"Unknown stationary family: {family}")


def stationary_forward_plain(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``var * h(max(square_distance(Xs, Zs), 0))``.
    float32 and bfloat16 inputs compute in float32, as K1 does; float64
    computes in float64."""
    dtype = torch.float64 if Xs.dtype == torch.float64 else torch.float32
    d2 = torch.clamp(square_distance(Xs.to(dtype), Zs.to(dtype)), min=0.0)
    a = None if alpha is None else torch.as_tensor(alpha).to(dtype)
    return torch.as_tensor(variance).to(dtype) * _tail_value(family, d2, a)


def k1_library() -> ctypes.CDLL:
    """K1's library, built by nvcc on first use in the process."""
    lib = load_library("gpflow_k1", ["stationary_k1.cu"])
    fn = lib.gpflow_k1_stationary_forward
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _scalar_on(device: torch.device, value: Optional[torch.Tensor], name: str) -> torch.Tensor:
    t = torch.as_tensor(value)
    if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"K1 takes {name} as one float32 element on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def stationary_forward_cuda(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launches K1 on the current CUDA stream: ``out[i, j] = var * h(d2)``.

    Xs: [N, D] and Zs: [M, D], contiguous CUDA tensors of one dtype (float32
    or bfloat16) on one device; variance and alpha: one float32 element each
    on that device (alpha is read by family "rq" only). Returns [N, M]
    float32. Raises on anything else, and NotImplementedError where autograd
    would need a gradient."""
    if family not in _FAMILY_CODES:
        raise ValueError(f"Unknown stationary family: {family}")
    if family == "rq" and alpha is None:
        raise ValueError("family='rq' requires alpha")
    for name, t in (("Xs", Xs), ("Zs", Zs)):
        if not t.is_cuda:
            raise ValueError(f"K1 takes CUDA tensors; {name} is on {t.device}")
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"K1 takes float32 or bfloat16; {name} is {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"K1 takes contiguous 2-D tensors; {name} has shape "
                             f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")
    if Xs.dtype != Zs.dtype or Xs.device != Zs.device or Xs.shape[1] != Zs.shape[1]:
        raise ValueError(f"K1 takes Xs and Zs of one dtype, device and width; got "
                         f"{Xs.dtype}/{Zs.dtype}, {Xs.device}/{Zs.device}, "
                         f"{tuple(Xs.shape)}/{tuple(Zs.shape)}")
    var = _scalar_on(Xs.device, variance, "variance")
    a = var if alpha is None else _scalar_on(Xs.device, alpha, "alpha")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (Xs, Zs, var, a)):
        raise NotImplementedError(
            "K1 has no backward yet: run CUDA predictions under torch.no_grad() "
            "(the autograd.Function comes with the training slice, ROADMAP.md)"
        )
    (N, D), M = Xs.shape, Zs.shape[0]
    if max(N, M, D) >= 2**31 or -(-N // _TILE_N) > 65535:
        raise ValueError(f"K1 grid too large for N={N}, M={M}, D={D}")
    out = torch.empty((N, M), dtype=torch.float32, device=Xs.device)
    if N == 0 or M == 0:
        return out
    lib = k1_library()
    with torch.cuda.device(Xs.device):
        stream = torch.cuda.current_stream(Xs.device).cuda_stream
        err = lib.gpflow_k1_stationary_forward(
            _FAMILY_CODES[family], int(Xs.dtype == torch.bfloat16),
            Xs.data_ptr(), Zs.data_ptr(), var.data_ptr(), a.data_ptr(), out.data_ptr(),
            N, M, D, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed with CUDA error {err}")
    launch_counts["K1"] += 1
    return out


def stationary_forward(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if Xs.is_cuda:
        return stationary_forward_cuda(family, Xs, Zs, variance, alpha)
    return stationary_forward_plain(family, Xs, Zs, variance, alpha)


def stationary_kernel_matrix(
    X: torch.Tensor,
    Z: torch.Tensor,
    lengthscales: torch.Tensor,
    variance: torch.Tensor,
    family: str = "rbf",
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K[i, j] = variance * h(||(X_i - Z_j) / lengthscales||^2) for the given
    isotropic family (``gpflow_tpu/ops/pallas_distance.py:306-325``)."""
    if family not in PALLAS_FAMILIES:
        raise ValueError(f"Unknown stationary family: {family}")
    if family == "rq" and alpha is None:
        raise ValueError("family='rq' requires alpha")
    Xs = (X / lengthscales).contiguous()
    Zs = (Z / lengthscales).contiguous()
    var = torch.as_tensor(variance).reshape(1).to(torch.float32) if Xs.is_cuda else variance
    if alpha is not None and Xs.is_cuda:
        alpha = torch.as_tensor(alpha).reshape(1).to(torch.float32)
    return stationary_forward(family, Xs, Zs, var, alpha)

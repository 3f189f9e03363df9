"""Fused stationary covariance matrices and their gradients: kernels K1 and
K2, their plain versions, the autograd Functions and the routing rule
(counterpart of ``gpflow_tpu/ops/pallas_distance.py``; the module and its
public names keep the JAX package's, where K1 and K2 are Pallas kernels).

``K[i, j] = variance * h(||xs_i - zs_j||^2)`` for inputs already divided by
the lengthscales, h one of ``PALLAS_FAMILIES``. The backward expresses every
gradient as matmuls against the VJP weight ``W = g * variance * h'(d2)``:

* where ``_routes_to_kernel`` holds, K1 computes K and, for the exponential
  and Matern families, K2 computes W: CUDA C++ kernels for Hopper
  (``gpflow_tpu_torch/csrc/stationary_k1.cu``, ``stationary_k2.cu``), built
  with nvcc on first use and loaded with ctypes, each launched as
  ``_launch_plan`` decides from the shapes and addresses alone. Each launch
  is a registered torch op, ``torch.ops.gpflow_tpu_torch.stationary_k1`` and
  ``stationary_k2``, with a CUDA implementation only and a fake one that
  gives the output's shape: ``torch.export`` keeps each as one node of the
  graph, and an exported program launches the kernel;
* elsewhere the plain PyTorch versions ``stationary_forward_plain`` and
  ``stationary_wgrad_plain`` compute the same functions;
* rbf and rq take W from the saved K, with no kernel, on both devices.

The switch ``set_pallas_enabled`` decides where the kernels serve
(``gpflow_tpu/ops/pallas_distance.py:44-75``): None (the default) sends a
CUDA tensor in float32 or bfloat16 to them; False sends every tensor to the
plain versions, on the card too; True sends every float32 or bfloat16 tensor
to them, and a CPU tensor then raises. Where the switch is None, the
environment variable ``GPFLOW_TPU_PALLAS`` decides if it is set, as True
(any value but "0", "false" and "False") or False. float64 never reaches K1 or K2,
whatever the switch says, as in the JAX package: the kernels compute in
float32. A request that a kernel cannot take raises; there is no fallback to
the plain version once the kernel is chosen.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import as_torch_dtype
from ..utilities.ops import square_distance
from .cuda_build import load_library

__all__ = [
    "LaunchPlan",
    "PALLAS_FAMILIES",
    "WGRAD_FAMILIES",
    "get_pallas_enabled",
    "k1_library",
    "k2_library",
    "launch_counts",
    "launch_plans",
    "pallas_available",
    "rbf_kernel_matrix",
    "scaled_squared_distance",
    "set_pallas_enabled",
    "stationary_forward",
    "stationary_forward_cuda",
    "stationary_forward_plain",
    "stationary_kernel_matrix",
    "stationary_wgrad",
    "stationary_wgrad_cuda",
    "stationary_wgrad_plain",
]

PALLAS_FAMILIES = ("rbf", "exponential", "matern12", "matern32", "matern52", "rq")
#: Families whose backward needs K2 (``pallas_distance.py:264-271``).
WGRAD_FAMILIES = ("exponential", "matern12", "matern32", "matern52")
_FAMILY_CODES = {f: i for i, f in enumerate(PALLAS_FAMILIES)}  # as in stationary_tile.cuh
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: Tile heights K1 and K2 are compiled for, tallest first (``kernel_for`` in
#: ``csrc/stationary_k1.cu`` and ``stationary_k2.cu``); every tile is
#: ``_TILE_COLS`` wide.
_TILE_ROWS = (64, 32, 16)
_TILE_COLS = 128
#: The tallest tile that still gives every SM this many tiles is taken.
_TILES_PER_SM = 4

#: Launches of each hand-written kernel in this process; a wrapper adds one
#: where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"K1": 0, "K2": 0}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch of K1 or K2 covers its [N, M] output (``_launch_plan``)."""

    tile_rows: int  # tile height, one of _TILE_ROWS; a tile is _TILE_COLS wide
    tiles: int  # ceil(N / tile_rows) * ceil(M / _TILE_COLS)
    grid: int  # persistent blocks: block b takes row-major tiles b, b + grid, ...
    tma: bool  # the output (and K2's g) by bulk tensor copies; else masked 4-byte accesses
    vec: bool  # Xs and Zs staged four dimensions per load; else one element per load


#: The plan of each kernel's last launch in this process.
launch_plans: Dict[str, Optional[LaunchPlan]] = {"K1": None, "K2": None}


def _launch_plan(
    kernel: str,
    N: int,
    M: int,
    D: int,
    out_ptr: int,
    g_ptr: Optional[int],
    sms: int,
    ctas_per_sm: Callable[[int, bool], int],
    xs_ptr: int,
    zs_ptr: int,
    in_itemsize: int,
) -> LaunchPlan:
    """The launch of ``kernel`` ("K1" or "K2") on Xs [N, D] and Zs [M, D]
    (``in_itemsize`` bytes an element), from shapes and addresses alone:

    * the tile height: the tallest of ``_TILE_ROWS`` that gives at least
      ``_TILES_PER_SM`` tiles per SM, else the shortest, so that a small
      shape still spreads over the card;
    * ``tma``: a bulk tensor copy needs rows of a multiple of 16 bytes
      (M % 4 == 0) and 16-byte aligned bases, the output's (``out_ptr``)
      and, for K2, g's (``g_ptr``);
    * ``vec``: loading four dimensions at once needs D % 4 == 0 and Xs and Zs
      aligned to four elements;
    * the grid: ``min(tiles, sms * ctas_per_sm(tile_rows, tma))``, the blocks
      the card keeps resident, ``ctas_per_sm`` giving those of one SM for
      that instantiation."""
    tiles_m = -(-M // _TILE_COLS)
    rows = next((r for r in _TILE_ROWS if -(-N // r) * tiles_m >= _TILES_PER_SM * sms), _TILE_ROWS[-1])
    tiles = -(-N // rows) * tiles_m
    io_ptrs = (out_ptr,) if kernel == "K1" else (out_ptr, g_ptr)
    tma = M % 4 == 0 and all(p % 16 == 0 for p in io_ptrs)
    vec = D % 4 == 0 and xs_ptr % (4 * in_itemsize) == 0 and zs_ptr % (4 * in_itemsize) == 0
    resident = ctas_per_sm(rows, tma)
    if sms < 1 or resident < 1:
        raise RuntimeError(f"{kernel}: the card keeps {resident} blocks resident on each of its {sms} SMs")
    return LaunchPlan(tile_rows=rows, tiles=tiles, grid=min(tiles, sms * resident), tma=tma, vec=vec)


_state: Dict[str, Optional[bool]] = {"enabled": None}  # None: auto


def set_pallas_enabled(value: Optional[bool]) -> None:
    """True or False forces the kernels on or off for float32 and bfloat16
    tensors; None restores auto (``pallas_distance.py:44-50``)."""
    _state["enabled"] = value


def get_pallas_enabled() -> Optional[bool]:
    """The switch: True or False, or None for auto (``pallas_distance.py:52-55``)."""
    return _state["enabled"]


def _switch() -> Optional[bool]:
    """The switch where set, else ``GPFLOW_TPU_PALLAS`` where set ("0",
    "false" and "False" turn the kernels off, any other value on), else None."""
    enabled = _state["enabled"]
    if enabled is not None:
        return bool(enabled)
    env = os.environ.get("GPFLOW_TPU_PALLAS")
    if env is not None:
        return env not in ("0", "false", "False")
    return None


def pallas_available(dtype: Any) -> bool:
    """True where K1 and K2 serve inputs of ``dtype`` (a torch or numpy
    dtype): never for float64; else as the switch or ``GPFLOW_TPU_PALLAS``
    says, and otherwise where a CUDA device is present, as the JAX package
    asks for the TPU backend (``gpflow_tpu/ops/pallas_distance.py:57-75``).
    Which tensor takes the kernel is ``_routes_to_kernel``'s rule."""
    if as_torch_dtype(dtype) not in _KERNEL_DTYPES:
        return False
    switch = _switch()
    return torch.cuda.is_available() if switch is None else switch


def _routes_to_kernel(X: torch.Tensor) -> bool:
    """The rule of the kernels' callers: ``pallas_available`` for X's dtype,
    where auto (neither switch nor environment set) only for a CUDA tensor.
    A CPU tensor let through by the switch raises at the kernel's wrapper."""
    if X.dtype not in _KERNEL_DTYPES:
        return False
    switch = _switch()
    return X.is_cuda if switch is None else switch


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


def _tail_grad(family: str, d2: torch.Tensor, alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dh/d(d2), analytic per family (``pallas_distance.py:101-121``).

    The r-based families are 0 wherever d2 falls under the 1e-36 clip: that
    is the derivative of ``h(sqrt(max(d2, 1e-36)))``, which the JAX package's
    XLA path differentiates (``gpflow_tpu/kernels/stationaries.py:94-95``).
    Without it the 1/r of exponential and Matern 1/2 gives about -5e17 at
    coincident points, and the input gradient's ``row . Xs - W Zs`` cancels
    to rounding noise of that size; Matern 3/2 and 5/2 change nothing there,
    since their term is multiplied by xs_i - zs_j = 0."""
    if family == "rbf":
        return -0.5 * torch.exp(-0.5 * d2)
    if family == "rq":
        return -0.5 * torch.exp(-(alpha + 1.0) * torch.log1p(0.5 * d2 / alpha))
    r = torch.sqrt(torch.clamp(d2, min=1e-36))
    if family == "exponential":
        grad = -torch.exp(-0.5 * r) / (4.0 * r)
    elif family == "matern12":
        grad = -torch.exp(-r) / (2.0 * r)
    elif family == "matern32":
        s = math.sqrt(3.0)
        grad = -1.5 * torch.exp(-s * r)
    elif family == "matern52":
        s = math.sqrt(5.0)
        grad = -(5.0 / 6.0) * (1.0 + s * r) * torch.exp(-s * r)
    else:
        raise ValueError(f"Unknown stationary family: {family}")
    return torch.where(d2 < 1e-36, torch.zeros_like(grad), grad)


def _plain_dtype(Xs: torch.Tensor) -> torch.dtype:
    """float64 computes in float64; float32 and bfloat16 in float32, as the
    kernels do."""
    return torch.float64 if Xs.dtype == torch.float64 else torch.float32


def _plain_d2(Xs: torch.Tensor, Zs: torch.Tensor) -> torch.Tensor:
    dtype = _plain_dtype(Xs)
    return torch.clamp(square_distance(Xs.to(dtype), Zs.to(dtype)), min=0.0)


def _direct_d2(Xs: torch.Tensor, Zs: torch.Tensor) -> torch.Tensor:
    """d2 as the kernels form it (``csrc/stationary_tile.cuh``): a sum of
    squared differences over the dimensions in order, one [N, M] pass per
    dimension. Exactly 0 at coincident points, where the norm expansion
    leaves rounding noise that the 1/r families' gradient turns into garbage."""
    dtype = _plain_dtype(Xs)
    x, z = Xs.to(dtype), Zs.to(dtype)
    d2 = torch.zeros((x.shape[0], z.shape[0]), dtype=dtype, device=x.device)
    for k in range(x.shape[1]):
        d2 += torch.square(x[:, k, None] - z[None, :, k])
    return d2


def stationary_forward_plain(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``var * h(max(square_distance(Xs, Zs), 0))``."""
    dtype = _plain_dtype(Xs)
    a = None if alpha is None else torch.as_tensor(alpha).to(dtype)
    return torch.as_tensor(variance).to(dtype) * _tail_value(family, _plain_d2(Xs, Zs), a)


def stationary_wgrad_plain(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``g * (var * h'(d2))`` with d2 formed as
    K2 forms it (``_direct_d2``), so that both give W = 0 at coincident
    points; K1's plain version keeps the norm expansion of the JAX package's
    kernel."""
    dtype = _plain_dtype(Xs)
    return g.to(dtype) * (torch.as_tensor(variance).to(dtype) * _tail_grad(family, _direct_d2(Xs, Zs)))


def _bind(lib: ctypes.CDLL, prefix: str, launch: str) -> ctypes.CDLL:
    """Sets the ctypes signatures of a kernel library's two entry points:
    ``<prefix>_<launch>(family, input_is_bf16, 5 pointers, n, m, d,
    tile_rows, grid, tma, vec, stream)`` and ``<prefix>_occupancy(family,
    input_is_bf16, tile_rows, tma, int *sms, int *ctas_per_sm)``."""
    fn = getattr(lib, f"{prefix}_{launch}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = getattr(lib, f"{prefix}_occupancy")
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2
    occ.restype = ctypes.c_int
    return lib


def k1_library() -> ctypes.CDLL:
    """K1's library, built by nvcc on first use in the process."""
    return _bind(load_library("gpflow_k1", ["stationary_k1.cu"]), "gpflow_k1", "stationary_forward")


def k2_library() -> ctypes.CDLL:
    """K2's library, built by nvcc on first use in the process."""
    return _bind(load_library("gpflow_k2", ["stationary_k2.cu"]), "gpflow_k2", "stationary_wgrad")


_occupancies: Dict[Tuple[str, int, str, bool, int, bool], Tuple[int, int]] = {}


def _occupancy(kernel: str, lib: ctypes.CDLL, family: str, bf16: bool, device: torch.device,
               tile_rows: int, tma: bool) -> Tuple[int, int]:
    """(SMs, resident blocks per SM) of one instantiation of K1 or K2 on
    ``device`` (the current device), queried once and cached."""
    key = (kernel, device.index, family, bf16, tile_rows, tma)
    if key not in _occupancies:
        sms, ctas = ctypes.c_int(0), ctypes.c_int(0)
        query = lib.gpflow_k1_occupancy if kernel == "K1" else lib.gpflow_k2_occupancy
        err = query(_FAMILY_CODES[family], int(bf16), tile_rows, int(tma), ctypes.byref(sms), ctypes.byref(ctas))
        if err != 0:
            raise RuntimeError(f"{kernel} occupancy query failed with CUDA error {err}")
        _occupancies[key] = (sms.value, ctas.value)
    return _occupancies[key]


def _plan_for(kernel: str, lib: ctypes.CDLL, family: str, Xs: torch.Tensor, Zs: torch.Tensor,
              out: torch.Tensor, g: Optional[torch.Tensor] = None) -> LaunchPlan:
    """``_launch_plan`` for these tensors, with the card's SMs and each
    instantiation's resident blocks."""
    bf16 = Xs.dtype == torch.bfloat16

    def occupancy(rows: int, tma: bool) -> Tuple[int, int]:
        return _occupancy(kernel, lib, family, bf16, Xs.device, rows, tma)

    (N, D), M = Xs.shape, Zs.shape[0]
    return _launch_plan(kernel, N, M, D, out.data_ptr(), None if g is None else g.data_ptr(),
                        occupancy(_TILE_ROWS[0], True)[0], lambda rows, tma: occupancy(rows, tma)[1],
                        Xs.data_ptr(), Zs.data_ptr(), Xs.element_size())


def _check_launch(kernel: str, err: int) -> None:
    """Raises unless an entry point returned 0; a negative code is a tensor
    map that ``cuTensorMapEncodeTiled`` refused (``kTensorMapError`` in
    ``csrc/stationary_tile.cuh``)."""
    if err < 0:
        raise RuntimeError(f"{kernel} launch failed: cuTensorMapEncodeTiled gave CUresult {-1 - err}")
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")


def _scalar_on(device: torch.device, value: Optional[torch.Tensor], name: str) -> torch.Tensor:
    t = torch.as_tensor(value)
    if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"the kernels take {name} as one float32 element on {device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t.contiguous()


def _check_on_card(kernel: str, Xs: torch.Tensor, Zs: torch.Tensor) -> None:
    """Raises unless Xs and Zs are CUDA tensors: the ops have no other
    implementation. Reads only the devices, which are known while
    ``torch.export`` traces with symbolic sizes."""
    for name, t in (("Xs", Xs), ("Zs", Zs)):
        if not t.is_cuda:
            raise ValueError(f"{kernel} takes CUDA tensors; {name} is on {t.device}")


def _check_inputs(kernel: str, Xs: torch.Tensor, Zs: torch.Tensor) -> None:
    """Raises unless Xs [N, D] and Zs [M, D] are contiguous CUDA tensors of
    one kernel dtype on one device, with N, M and D in int32. The grid is
    persistent and one-dimensional, so N and M have no other limit; N * M
    itself may pass 2^31: the kernels index tiles and offset every row of an
    [N, M] matrix in int64 (``csrc/stationary_tile.cuh``)."""
    _check_on_card(kernel, Xs, Zs)
    for name, t in (("Xs", Xs), ("Zs", Zs)):
        if t.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"{kernel} takes float32 or bfloat16; {name} is {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous 2-D tensors; {name} has shape "
                             f"{tuple(t.shape)}, contiguous={t.is_contiguous()}")
    if Xs.dtype != Zs.dtype or Xs.device != Zs.device or Xs.shape[1] != Zs.shape[1]:
        raise ValueError(f"{kernel} takes Xs and Zs of one dtype, device and width; got "
                         f"{Xs.dtype}/{Zs.dtype}, {Xs.device}/{Zs.device}, "
                         f"{tuple(Xs.shape)}/{tuple(Zs.shape)}")
    (N, D), M = Xs.shape, Zs.shape[0]
    if max(N, M, D) >= 2**31:
        raise ValueError(f"{kernel} takes N, M and D below 2^31; got N={N}, M={M}, D={D}")


@torch.library.custom_op("gpflow_tpu_torch::stationary_k1", mutates_args=(), device_types="cuda")
def _k1_op(family: str, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor,
           alpha: Optional[torch.Tensor]) -> torch.Tensor:
    """K1's launch on the current CUDA stream, the CUDA implementation of
    ``torch.ops.gpflow_tpu_torch.stationary_k1``: checks, plans, launches and
    counts. It reads no value on the host, so it never synchronises."""
    _check_inputs("K1", Xs, Zs)
    var = _scalar_on(Xs.device, variance, "variance")
    a = var if alpha is None else _scalar_on(Xs.device, alpha, "alpha")
    (N, D), M = Xs.shape, Zs.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=Xs.device)
    if N == 0 or M == 0:
        return out
    lib = k1_library()
    with torch.cuda.device(Xs.device):
        plan = _plan_for("K1", lib, family, Xs, Zs, out)
        stream = torch.cuda.current_stream(Xs.device).cuda_stream
        err = lib.gpflow_k1_stationary_forward(
            _FAMILY_CODES[family], int(Xs.dtype == torch.bfloat16),
            Xs.data_ptr(), Zs.data_ptr(), var.data_ptr(), a.data_ptr(), out.data_ptr(),
            N, M, D, plan.tile_rows, plan.grid, int(plan.tma), int(plan.vec), stream,
        )
    _check_launch("K1", err)
    launch_counts["K1"] += 1
    launch_plans["K1"] = plan
    return out


@_k1_op.register_fake
def _k1_fake(family: str, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor,
             alpha: Optional[torch.Tensor]) -> torch.Tensor:
    """K1's output [N, M] float32 on the inputs' device, for tracing: no launch."""
    return Xs.new_empty((Xs.shape[0], Zs.shape[0]), dtype=torch.float32)


@torch.library.custom_op("gpflow_tpu_torch::stationary_k2", mutates_args=(), device_types="cuda")
def _k2_op(family: str, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor,
           g: torch.Tensor) -> torch.Tensor:
    """K2's launch on the current CUDA stream, the CUDA implementation of
    ``torch.ops.gpflow_tpu_torch.stationary_k2``: checks, plans, launches and
    counts, with no host synchronisation."""
    _check_inputs("K2", Xs, Zs)
    (N, D), M = Xs.shape, Zs.shape[0]
    if (g.device != Xs.device or g.dtype != torch.float32 or tuple(g.shape) != (N, M)
            or not g.is_contiguous()):
        raise ValueError(f"K2 takes g as a contiguous [{N}, {M}] float32 tensor on {Xs.device}; "
                         f"got {tuple(g.shape)} {g.dtype} on {g.device}, "
                         f"contiguous={g.is_contiguous()}")
    var = _scalar_on(Xs.device, variance, "variance")
    W = torch.empty((N, M), dtype=torch.float32, device=Xs.device)
    if N == 0 or M == 0:
        return W
    lib = k2_library()
    with torch.cuda.device(Xs.device):
        plan = _plan_for("K2", lib, family, Xs, Zs, W, g)
        stream = torch.cuda.current_stream(Xs.device).cuda_stream
        err = lib.gpflow_k2_stationary_wgrad(
            _FAMILY_CODES[family], int(Xs.dtype == torch.bfloat16),
            Xs.data_ptr(), Zs.data_ptr(), var.data_ptr(), g.data_ptr(), W.data_ptr(),
            N, M, D, plan.tile_rows, plan.grid, int(plan.tma), int(plan.vec), stream,
        )
    _check_launch("K2", err)
    launch_counts["K2"] += 1
    launch_plans["K2"] = plan
    return W


@_k2_op.register_fake
def _k2_fake(family: str, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """K2's output [N, M] float32 on the inputs' device, for tracing: no launch."""
    return Xs.new_empty((Xs.shape[0], Zs.shape[0]), dtype=torch.float32)


def stationary_forward_cuda(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launches K1 on the current CUDA stream through its op:
    ``out[i, j] = var * h(d2)``.

    Xs: [N, D] and Zs: [M, D], contiguous CUDA tensors of one dtype (float32
    or bfloat16) on one device; variance and alpha: one float32 element each
    on that device (alpha is read by family "rq" only). Returns [N, M]
    float32, outside autograd (``stationary_kernel_matrix`` differentiates).
    Raises on anything else."""
    if family not in _FAMILY_CODES:
        raise ValueError(f"Unknown stationary family: {family}")
    if family == "rq" and alpha is None:
        raise ValueError("family='rq' requires alpha")
    _check_on_card("K1", Xs, Zs)
    return torch.ops.gpflow_tpu_torch.stationary_k1(family, Xs, Zs, variance, alpha)


def stationary_wgrad_cuda(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """Launches K2 on the current CUDA stream through its op:
    ``W[i, j] = g[i, j] * var * h'(d2)``.

    family: one of ``WGRAD_FAMILIES``; Xs: [N, D] and Zs: [M, D], contiguous
    CUDA tensors of one dtype (float32 or bfloat16) on one device; variance:
    one float32 element on that device; g: [N, M] contiguous float32 on that
    device. Returns W [N, M] float32. Raises on anything else."""
    if family not in WGRAD_FAMILIES:
        raise ValueError(f"K2 serves the families {WGRAD_FAMILIES}, not {family!r} "
                         "(rbf and rq take W from the saved K)")
    _check_on_card("K2", Xs, Zs)
    return torch.ops.gpflow_tpu_torch.stationary_k2(family, Xs, Zs, variance, g)


def stationary_forward(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 where ``_routes_to_kernel(Xs)``, else the plain version."""
    if _routes_to_kernel(Xs):
        return stationary_forward_cuda(family, Xs, Zs, variance, alpha)
    return stationary_forward_plain(family, Xs, Zs, variance, alpha)


def stationary_wgrad(
    family: str,
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """K2 where ``_routes_to_kernel(Xs)``, else the plain version."""
    if _routes_to_kernel(Xs):
        return stationary_wgrad_cuda(family, Xs, Zs, variance, g.contiguous())
    return stationary_wgrad_plain(family, Xs, Zs, variance, g)


def _stationary_bwd_from_w(
    needs: Tuple[bool, bool, bool],
    Xs: torch.Tensor,
    Zs: torch.Tensor,
    variance: torch.Tensor,
    K: torch.Tensor,
    W: torch.Tensor,
    g: torch.Tensor,
) -> Tuple[Optional[torch.Tensor], ...]:
    """dXs, dZs, dvar from the VJP weight W = g * var * h'(d2)
    (``pallas_distance.py:237-251``): d(d2)/dXs_i = 2 (Xs_i - Zs_j) per pair
    contracts to dXs = 2 (rowsum(W) Xs - W Zs) and its transpose for dZs,
    and dK/dvar = K / var. The two contractions, each with W's row or column
    sums as one more column, accumulate in float64: in float32 the
    difference cancels where the inputs lie many lengthscales from the
    origin (a 1-D series 50 lengthscales long kept 1e-2 of its lengthscale's
    gradient, ROADMAP F2). Each result is cast back to its input's dtype;
    ``needs`` skips the gradients autograd does not ask for."""
    dXs = dZs = dvar = None
    if needs[0] or needs[1]:
        W64 = W.to(torch.float64)
        x, z = Xs.to(torch.float64), Zs.to(torch.float64)
        if needs[0]:
            Wz = W64 @ torch.cat([z, torch.ones_like(z[:, :1])], dim=1)  # [N, D + 1]: W z, rowsum(W)
            dXs = (2.0 * (Wz[:, -1:] * x - Wz[:, :-1])).to(Xs.dtype)
        if needs[1]:
            Wx = W64.mT @ torch.cat([x, torch.ones_like(x[:, :1])], dim=1)  # [M, D + 1]: W^T x, colsum(W)
            dZs = (2.0 * (Wx[:, -1:] * z - Wx[:, :-1])).to(Zs.dtype)
        del W64
    if needs[2]:
        dvar = (torch.sum(g * K) / variance.to(K.dtype)).reshape(variance.shape).to(variance.dtype)
    return dXs, dZs, dvar


class _Stationary(torch.autograd.Function):
    """K = var * h(d2) with its custom VJP, the counterpart of
    ``_make_stationary(family)`` (``pallas_distance.py:254-274``); the
    family is the first argument. Forward is K1 (CUDA) or its plain version
    (CPU). Backward: for rbf W = -g K / 2 from the saved K; for the other
    families W comes from K2 (CUDA) or its plain version (CPU)."""

    @staticmethod
    def forward(ctx, family: str, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
        K = stationary_forward(family, Xs, Zs, variance)
        ctx.family = family
        ctx.save_for_backward(Xs, Zs, variance, K)
        return K

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        Xs, Zs, variance, K = ctx.saved_tensors
        if ctx.family == "rbf":
            W = -0.5 * (g * K)  # h' = -h / 2
        else:
            W = stationary_wgrad(ctx.family, Xs, Zs, variance, g)
        return (None,) + _stationary_bwd_from_w(ctx.needs_input_grad[1:], Xs, Zs, variance, K, W, g)


class _RationalQuadratic(torch.autograd.Function):
    """The rq counterpart of ``_Stationary`` (``pallas_distance.py:277-303``).
    Every gradient comes elementwise from the saved K: with u = d2/(2 alpha),
    1 + u = (K/var)^(-1/alpha), W = -g K / (2 (1 + u)) and
    dK/dalpha = K (u/(1+u) - log1p(u))."""

    @staticmethod
    def forward(ctx, Xs: torch.Tensor, Zs: torch.Tensor, variance: torch.Tensor,
                alpha: torch.Tensor) -> torch.Tensor:
        K = stationary_forward("rq", Xs, Zs, variance, alpha)
        ctx.save_for_backward(Xs, Zs, variance, alpha, K)
        return K

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        Xs, Zs, variance, alpha, K = ctx.saved_tensors
        a = alpha.to(K.dtype)
        ratio = torch.clamp(K / variance.to(K.dtype), min=1e-38)
        one_plus_u = torch.exp(-torch.log(ratio) / a)
        u = one_plus_u - 1.0
        W = -0.5 * (g * K) / one_plus_u
        grads = _stationary_bwd_from_w(ctx.needs_input_grad[:3], Xs, Zs, variance, K, W, g)
        dalpha = None
        if ctx.needs_input_grad[3]:
            dalpha = torch.sum(g * K * (u / one_plus_u - torch.log(one_plus_u)))
            dalpha = dalpha.reshape(alpha.shape).to(alpha.dtype)
        return grads + (dalpha,)


def stationary_kernel_matrix(
    X: torch.Tensor,
    Z: torch.Tensor,
    lengthscales: torch.Tensor,
    variance: torch.Tensor,
    family: str = "rbf",
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K[i, j] = variance * h(||(X_i - Z_j) / lengthscales||^2) for the given
    isotropic family, differentiable with respect to every tensor input
    (``gpflow_tpu/ops/pallas_distance.py:306-325``). Where the kernels serve,
    the scalars reach them as float32 [1] tensors on the device; their
    gradients flow back through that reshape and cast."""
    if family not in PALLAS_FAMILIES:
        raise ValueError(f"Unknown stationary family: {family}")
    if family == "rq" and alpha is None:
        raise ValueError("family='rq' requires alpha")
    Xs = (X / lengthscales).contiguous()
    Zs = (Z / lengthscales).contiguous()
    variance = torch.as_tensor(variance)
    on_kernel = _routes_to_kernel(Xs)
    if on_kernel:
        variance = variance.reshape(1).to(torch.float32)
    if family == "rq":
        alpha = torch.as_tensor(alpha)
        if on_kernel:
            alpha = alpha.reshape(1).to(torch.float32)
        return _RationalQuadratic.apply(Xs, Zs, variance, alpha)
    return _Stationary.apply(family, Xs, Zs, variance)


def rbf_kernel_matrix(
    X: torch.Tensor,
    Z: torch.Tensor,
    lengthscales: torch.Tensor,
    variance: torch.Tensor,
) -> torch.Tensor:
    """K[i, j] = variance * exp(-0.5 ||(X_i - Z_j) / lengthscales||^2),
    differentiable with respect to every input (``pallas_distance.py:328-336``):
    ``stationary_kernel_matrix`` with family rbf, so K1 where it serves."""
    return stationary_kernel_matrix(X, Z, lengthscales, variance, family="rbf")


def scaled_squared_distance(Xs: torch.Tensor, Zs: torch.Tensor) -> torch.Tensor:
    """||xs - zs||^2 for inputs already divided by the lengthscales, computed
    directly by ``square_distance`` and never through K1
    (``pallas_distance.py:357-369``): recovering d2 from exp(-d2 / 2) in
    float32 would clamp large distances and blur small ones."""
    return square_distance(Xs, Zs)

"""Mesh construction and sharding placements (counterpart of
``gpflow_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks of the
default process group, one device per rank, its dimensions named by the
axis names. Every rank builds the same mesh (SPMD): where the mesh has more
than one dimension its subgroups are made collectively. The mesh's device
type is that of ``config.default_device()``: "cuda" needs the NCCL backend
and "cpu" gloo, and a mismatch raises. Where no group exists and the mesh
has one rank, ``make_mesh`` starts a one-rank group on an in-process
``HashStore`` (no network, no port); a mesh of more ranks needs a group
made by the caller (``torch.distributed.init_process_group``).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import default_device

try:
    from torch.distributed.tensor import Placement, Replicate, Shard
except ImportError:  # torch < 2.5 keeps DTensor's placements private
    from torch.distributed._tensor import Placement, Replicate, Shard  # type: ignore[no-redef]

__all__ = ["make_hybrid_mesh", "make_mesh", "replicated", "shard_batch"]

DEFAULT_AXIS = "data"
LATENT_AXIS = "latent"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _world(requested: Optional[int]) -> int:
    """The default group's size; starts a one-rank group where there is none
    and at most one rank is asked for."""
    if not dist.is_initialized():
        if requested not in (None, 1):
            return 1
        backend = _BACKENDS.get(default_device().type)
        if backend is None:
            raise ValueError(f"no process-group backend for device type {default_device().type!r}")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def _device_mesh(ranks: Sequence[int], sizes: Tuple[int, ...], names: Tuple[str, ...]) -> DeviceMesh:
    device_type = default_device().type
    backend = dist.get_backend()
    if _BACKENDS.get(device_type) != backend:
        raise ValueError(
            f"a mesh over {device_type} tensors needs the {_BACKENDS.get(device_type)} backend, "
            f"but the default process group is {backend}"
        )
    return DeviceMesh(device_type, torch.tensor(list(ranks)).reshape(sizes), mesh_dim_names=names)


def _rank_of(device: Any) -> int:
    return int(getattr(device, "id", device))


def make_mesh(
    num_devices: Optional[int] = None,
    axis_name: str = DEFAULT_AXIS,
    devices: Optional[Sequence[Any]] = None,
    shape: Optional[Mapping[str, int]] = None,
) -> DeviceMesh:
    """Device mesh for scale-out: by default a 1-D mesh named ``axis_name``
    over every rank. ``shape`` builds an N-D mesh instead, e.g.
    ``{"data": 4, "latent": 2}``, its axes in the mapping's order.
    ``devices`` are the ranks to use (ints, or objects with an ``id``),
    default every rank of the default group in order."""
    if shape is not None and num_devices is not None:
        raise ValueError(
            "Pass either `shape` or `num_devices`, not both (the mesh "
            "size is the product of the `shape` sizes)."
        )
    requested = int(np.prod([int(s) for s in shape.values()])) if shape is not None else num_devices
    world = _world(None if devices is not None else requested)
    ranks = [_rank_of(d) for d in devices] if devices is not None else list(range(world))
    if shape is not None:
        names = tuple(shape)
        sizes = tuple(int(shape[n]) for n in names)
        if requested > len(ranks):
            raise ValueError(f"mesh shape {dict(shape)} needs {requested} devices, have {len(ranks)}")
        return _device_mesh(ranks[:requested], sizes, names)
    n = num_devices if num_devices is not None else len(ranks)
    if n > len(ranks):
        # as the shape= path: a smaller mesh than asked for would double each
        # rank's batch and break the caller's divisibility without a signal
        raise ValueError(f"num_devices={n} requested but only {len(ranks)} available")
    return _device_mesh(ranks[:n], (n,), (axis_name,))


def make_hybrid_mesh(
    ici: Mapping[str, int],
    dcn: Optional[Mapping[str, int]] = None,
    devices: Optional[Sequence[Any]] = None,
) -> DeviceMesh:
    """The JAX package's DCN-aware mesh: each axis has size
    ``ici[name] * dcn.get(name, 1)``, the ``dcn`` factor outermost. The
    ranks of one host are one slice, so the mesh is the reshape of
    ``gpflow_tpu/parallel/mesh.py:119-128``. ``devices`` may carry a
    ``slice_index``, as the JAX package's devices do: the slice counts are
    checked as there, and a layout over several slices raises
    ``NotImplementedError``."""
    dcn = dict(dcn or {})
    unknown = set(dcn) - set(ici)
    if unknown:
        raise ValueError(
            f"dcn axes {sorted(unknown)} not in ici axes {sorted(ici)}; "
            "declare every axis in `ici` (use ici size 1 for pure-DCN axes)"
        )
    names = tuple(ici)
    ici_sizes = tuple(int(ici[n]) for n in names)
    dcn_sizes = tuple(int(dcn.get(n, 1)) for n in names)
    ici_total = int(np.prod(ici_sizes))
    dcn_total = int(np.prod(dcn_sizes))
    total = ici_total * dcn_total
    devices = list(devices) if devices is not None else list(range(_world(total)))
    if total > len(devices):
        raise ValueError(
            f"hybrid mesh ici={dict(ici)} x dcn={dcn} needs {total} devices, have {len(devices)}"
        )
    by_slice: dict = {}
    for d in devices:
        by_slice.setdefault(getattr(d, "slice_index", None) or 0, []).append(d)
    if len(by_slice) > 1:
        slice_ids = sorted(by_slice)
        if dcn_total > len(slice_ids):
            raise ValueError(f"hybrid mesh dcn={dcn} needs {dcn_total} slices, have {len(slice_ids)}")
        short = [s for s in slice_ids if len(by_slice[s]) < ici_total]
        if len(slice_ids) - len(short) < dcn_total:
            raise ValueError(
                f"hybrid mesh ici={dict(ici)} needs {ici_total} devices per "
                f"slice on {dcn_total} slices; slices {short} have fewer"
            )
        raise NotImplementedError("a mesh over several slices: the ranks of one host are one slice")
    # one slice: the DCN factor of each axis outermost, (d0..dk, i0..ik)
    # interleaved to (d0, i0, d1, i1, ...) and merged per axis
    k = len(names)
    ranks = np.array([_rank_of(d) for d in devices[:total]]).reshape(dcn_sizes + ici_sizes)
    ranks = ranks.transpose([x for i in range(k) for x in (i, k + i)])
    sizes = tuple(d * i for d, i in zip(dcn_sizes, ici_sizes))
    return _device_mesh(ranks.reshape(-1).tolist(), sizes, names)


def replicated(mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements that replicate a tensor over every mesh axis."""
    return tuple(Replicate() for _ in range(mesh.ndim))


def shard_batch(mesh: DeviceMesh, axis_name: str = DEFAULT_AXIS) -> Tuple[Placement, ...]:
    """DTensor placements that split the leading (batch) axis over
    ``axis_name`` and replicate over the other axes."""
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"{axis_name!r} is not an axis of the mesh {names}")
    return tuple(Shard(0) if n == axis_name else Replicate() for n in names)


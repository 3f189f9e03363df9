"""Deployable serving artifacts through ``torch.export`` (counterpart of
``gpflow_tpu/utilities/serving.py``).

``export_serving`` exports a trained model's predict methods as
``ExportedProgram``s, saved with ``torch.export.save`` beside a
``serving.json`` of metadata: a frozen copy's parameters and its posterior
cache live in each program as its parameters and buffers, and the batch axis
is symbolic, fixed, or bucketed (one fixed-shape program per bucket).
``load_serving`` loads the artifact without the model code: it imports the
kernel ops' registrations (``gpflow_tpu_torch.ops``) and nothing of
``gpflow_tpu_torch.models``.

    export_serving(model, "/path/artifact", input_dim=8)
    served = load_serving("/path/artifact")
    mean, var = served.predict_f(Xnew)

An ``ExportedProgram`` holds one device's program, so an artifact serves on
the device type its model lived on (``"cuda"`` or ``"cpu"``), and a CUDA
artifact needs a card to load. The stationary covariances of a CUDA float32
model stay on kernel K1 in every export, symbolic, fixed or bucketed: K1 is
the registered op ``torch.ops.gpflow_tpu_torch.stationary_k1``, whose fake
implementation traces any batch; ``set_pallas_enabled(False)`` at export
gives a plain-path artifact. The route is frozen at export: ``inv_solve``'s
state, the default float and the jitter are those of the export.

For re-trainable persistence use ``save_checkpoint``/``load_checkpoint`` or
``parameter_dict`` with ``multiple_assign`` instead.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import ops as _ops  # noqa: F401  (registers the kernel ops that the programs call)
from ..config import as_torch_dtype, default_float
from .traversal import freeze

__all__ = ["ServedModel", "export_serving", "load_serving"]

_METADATA_FILE = "serving.json"
#: The rows of the example input a symbolic-batch export traces with; any
#: size above 1 would do (torch.export specialises sizes 0 and 1).
_EXAMPLE_ROWS = 2


def _build_method(model: Any, name: str, posterior: Optional[Any]) -> Callable[[torch.Tensor], Any]:
    """The function that serves ``name`` (``serving.py:39-69``).
    ``posterior`` is the model's cache, built once by ``export_serving`` and
    shared by every exported method."""
    if name in ("predict_f", "predict_y"):
        # serve through the cached posterior where the model offers one
        if posterior is not None:
            if name == "predict_f":
                return lambda X: posterior.predict_f(X)
            likelihood = getattr(model, "likelihood", None)
            if likelihood is not None and hasattr(likelihood, "predict_mean_and_var"):

                def predict_y(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
                    fmean, fvar = posterior.predict_f(X)
                    return likelihood.predict_mean_and_var(X, fmean, fvar)

                return predict_y
        fn = getattr(model, name)
        return lambda X: fn(X)
    if name == "predict_mean":
        if posterior is not None and hasattr(posterior, "predict_mean"):
            return lambda X: posterior.predict_mean(X)
        if posterior is not None:
            return lambda X: posterior.predict_f(X)[0]
        return lambda X: model.predict_f(X)[0]
    raise ValueError(f"Unknown serving method {name!r}")


_MODULE_STATE = frozenset(vars(nn.Module()))  # nn.Module's own bookkeeping attributes


class _BufferName(str):
    """A buffer's name in the place of a held tensor among a slot's leaves."""


class _Served(nn.Module):
    """One served method as a module for ``torch.export``. The frozen model
    is a submodule, so its parameters become the program's (a posterior
    built from it shares them); every tensor that the model or its posterior
    holds outside a parameter (the posterior's cache, a GPR's data) becomes a
    buffer, which ``forward`` puts in its place while the method runs, so
    that no tensor is a lifted constant."""

    def __init__(self, method: Callable[[torch.Tensor], Any], model: nn.Module,
                 posterior: Optional[nn.Module]) -> None:
        super().__init__()
        self._method = method
        self.model = model
        # (module, attribute, its leaves with buffer names in the held tensors' places, tree spec)
        self._slots: List[Tuple[nn.Module, str, List[Any], Any]] = []
        names: Dict[int, str] = {}
        for holder in (model,) if posterior is None else (model, posterior):
            for module in holder.modules():
                for attr, value in vars(module).items():
                    if attr in _MODULE_STATE:
                        continue
                    leaves, spec = tree_flatten(value)
                    held = [i for i, t in enumerate(leaves)
                            if isinstance(t, torch.Tensor) and not isinstance(t, nn.Parameter)]
                    for i in held:
                        t = leaves[i]
                        if id(t) not in names:
                            names[id(t)] = f"held_{len(names)}"
                            # contiguous: an expanded view would save as a partial storage
                            self.register_buffer(names[id(t)], t.detach().clone(memory_format=torch.contiguous_format))
                        leaves[i] = _BufferName(names[id(t)])
                    if held:
                        self._slots.append((module, attr, leaves, spec))

    def forward(self, X: torch.Tensor) -> Any:
        saved = []
        try:
            for module, attr, leaves, spec in self._slots:
                saved.append((module, attr, module.__dict__[attr]))
                module.__dict__[attr] = tree_unflatten(
                    [getattr(self, t) if isinstance(t, _BufferName) else t for t in leaves], spec)
            return self._method(X)
        finally:
            for module, attr, value in saved:
                module.__dict__[attr] = value


def _model_device(model: nn.Module) -> torch.device:
    for t in model.parameters():
        return t.device
    raise ValueError(f"{type(model).__name__} has no parameters to tell its device")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def export_serving(
    model: Any,
    path: str,
    input_dim: int,
    dtype: Optional[torch.dtype] = None,
    methods: Sequence[str] = ("predict_f", "predict_y"),
    platforms: Optional[Sequence[str]] = None,
    batch_symbol: str = "batch",
    batch_size: Optional[int] = None,
    bucket_sizes: Optional[Sequence[int]] = None,
) -> Dict[str, str]:
    """Exports predict methods to a self-contained artifact under ``path``.

    :param model: a trained model (GPR, SGPR, SVGP, VGP, ...: anything with
        the requested predict methods). A frozen deep copy is exported, so
        later assigns to the model do not reach the artifact.
    :param input_dim: D of the [N, D] prediction inputs.
    :param dtype: the input dtype (default ``default_float()``).
    :param methods: the endpoints; ``predict_f``, ``predict_y`` and
        ``predict_mean`` go through the posterior cache where the model has
        ``posterior()``.
    :param platforms: the device type the programs run on; it must be the
        model's, which is the default (an ``ExportedProgram`` holds one
        device's program). Any other, ``"tpu"`` among them, raises.
    :param batch_symbol: the name of the symbolic batch axis.
    :param batch_size: a fixed batch size instead of a symbolic one; pair the
        loaded artifact with ``bucketize`` to serve any N.
    :param bucket_sizes: one fixed-shape program per bucket size; the loader
        serves N on the smallest bucket that holds it, zero-padded, and N
        beyond the largest bucket in chunks of the largest.
    :returns: method name (``name@bucket`` for bucketed exports) -> file.
    """
    device = _model_device(model)
    platforms = (device.type,) if platforms is None else tuple(platforms)
    if not platforms or set(platforms) != {device.type}:
        raise ValueError(f"platforms {list(platforms)}: an artifact serves on its model's device type "
                         f"only, here ({device.type!r},)")
    dtype = as_torch_dtype(dtype) if dtype is not None else default_float()
    if bucket_sizes is not None:
        if batch_size is not None:
            raise ValueError("pass either batch_size or bucket_sizes, not both")
        buckets = sorted(int(b) for b in bucket_sizes)
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bucket_sizes must be positive, got {bucket_sizes}")
        sizes, dynamic = buckets, None
    elif batch_size is None:
        buckets = None
        sizes, dynamic = [_EXAMPLE_ROWS], ({0: torch.export.Dim(batch_symbol)},)
    else:
        buckets = None
        sizes, dynamic = [int(batch_size)], None
    os.makedirs(path, exist_ok=True)

    frozen = freeze(model)
    with torch.no_grad():
        posterior = frozen.posterior() if hasattr(frozen, "posterior") else None
    written: Dict[str, str] = {}
    for name in methods:
        served = _Served(_build_method(frozen, name, posterior), frozen, posterior)
        for n in sizes:
            example = torch.zeros((n, input_dim), dtype=dtype, device=device)
            program = torch.export.export(served, (example,), dynamic_shapes=dynamic)
            key = f"{name}@{n}" if buckets is not None else name
            written[key] = os.path.join(path, f"{key}.pt2")
            torch.export.save(program, written[key])

    with open(os.path.join(path, _METADATA_FILE), "w") as f:
        json.dump(
            {
                "methods": list(methods),
                "input_dim": int(input_dim),
                "dtype": _dtype_name(dtype),
                "platforms": list(platforms),
                "batch_size": batch_size,
                "bucket_sizes": buckets,
                "model_class": type(model).__name__,
            },
            f,
            indent=2,
        )
    return written


class ServedModel:
    """A loaded serving artifact: one callable per exported method, which
    casts its input to the artifact's dtype and device. Each program's
    module is made once, at load.

    For a bucketed artifact a call serves N on the smallest bucket that
    holds it, zero-padded, and slices the outputs back to N; N beyond the
    largest bucket is served in chunks of the largest (``serving.py:208-242``)."""

    def __init__(self, path: str) -> None:
        with open(os.path.join(path, _METADATA_FILE)) as f:
            self.metadata = json.load(f)
        (platform,) = self.metadata["platforms"]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} is a CUDA artifact and this process sees no CUDA device")
        self._device = torch.device(platform)
        self._dtype = getattr(torch, self.metadata["dtype"])
        self._methods: Dict[str, Any] = {}
        buckets = self.metadata.get("bucket_sizes")
        for name in self.metadata["methods"]:
            if buckets is not None:
                table = {int(b): self._load(path, f"{name}@{b}") for b in buckets}
                self._methods[name] = table
                setattr(self, name, self._make_bucketed_caller(table))
            else:
                module = self._load(path, name)
                self._methods[name] = module
                setattr(self, name, self._make_caller(module))

    @staticmethod
    def _load(path: str, key: str) -> nn.Module:
        return torch.export.load(os.path.join(path, f"{key}.pt2")).module()

    def _input(self, X: Any) -> torch.Tensor:
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X))
        return X.to(device=self._device, dtype=self._dtype)

    def _make_caller(self, module: nn.Module) -> Callable[[Any], Any]:
        def call(X: Any) -> Any:
            with torch.no_grad():
                return module(self._input(X))

        return call

    def _make_bucketed_caller(self, table: Dict[int, nn.Module]) -> Callable[[Any], Any]:
        buckets = sorted(table)
        max_bucket = buckets[-1]

        def call_padded(X: torch.Tensor) -> Any:
            n = X.shape[0]
            bucket = next(b for b in buckets if b >= n)
            pad = bucket - n
            Xp = torch.cat([X, X.new_zeros((pad, X.shape[1]))]) if pad else X
            with torch.no_grad():
                out = table[bucket](Xp)
            if not pad:
                return out
            if isinstance(out, (tuple, list)):
                return type(out)(o[:n] for o in out)
            return out[:n]

        def call(X: Any) -> Any:
            X = self._input(X)
            n = X.shape[0]
            if n <= max_bucket:
                return call_padded(X)
            parts = [call_padded(X[i:i + max_bucket]) for i in range(0, n, max_bucket)]
            first = parts[0]
            if isinstance(first, (tuple, list)):
                return type(first)(torch.cat([p[i] for p in parts]) for i in range(len(first)))
            return torch.cat(parts)

        return call

    @property
    def methods(self) -> Sequence[str]:
        return list(self._methods)


def load_serving(path: str) -> ServedModel:
    """Loads an ``export_serving`` artifact; needs the kernel ops'
    registrations, not the model code that produced it."""
    return ServedModel(path)

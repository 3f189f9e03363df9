"""Module-tree traversal, parameter paths, summaries, bulk assignment and
copies (counterpart of ``gpflow_tpu/utilities/traversal.py``)."""
from __future__ import annotations

import copy as _copy
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, TypeVar, Union

import numpy as np
import torch
from torch import nn

from ..base import Parameter
from ..config import default_summary_fmt

__all__ = [
    "deepcopy",
    "freeze",
    "leaf_components",
    "load_jax_values",
    "multiple_assign",
    "parameter_dict",
    "print_summary",
    "read_values",
    "reset_cache_bijectors",
    "select_dict_parameters_with_prior",
    "tabulate_module_summary",
    "traverse_module",
]

M = TypeVar("M", bound=nn.Module)
Path = str
LeafComponent = Union[Parameter, torch.Tensor]

# what every nn.Module keeps in its __dict__ (hooks, flags, the registries
# of children, parameters and buffers), which is not the model's state
_TORCH_MODULE_ATTRIBUTES = frozenset(vars(nn.Module()))


def _children(m: nn.Module) -> Dict[str, Any]:
    """A module's attributes as the JAX package's ``vars(m)`` holds them:
    plain attributes, submodules (Parameters among them), tensors."""
    out = {k: v for k, v in vars(m).items() if k not in _TORCH_MODULE_ATTRIBUTES}
    out.update(m._modules)
    out.update(m._parameters)
    out.update(m._buffers)
    return out


def traverse_module(
    m: Any,
    acc: Tuple[Path, Any],
    update_cb: Callable[[Any, Path, Any], Any],
    target_types: Tuple[type, ...],
) -> Any:
    """Walks ``m`` depth first, each module's attributes in sorted order,
    calling ``state = update_cb(leaf, path, state)`` on every instance of
    ``target_types``; returns the final state (``gpflow_tpu/utilities/traversal.py:49-71``).
    A Parameter is a leaf, an ``nn.ModuleList`` a list (``.kernels[0]``)."""
    path, state = acc
    if isinstance(m, target_types):
        state = update_cb(m, path, state)
    if isinstance(m, Parameter):
        return state
    if isinstance(m, (list, tuple, nn.ModuleList)):
        for i, item in enumerate(m):
            state = traverse_module(item, (f"{path}[{i}]", state), update_cb, target_types)
    elif isinstance(m, nn.Module):
        children = _children(m)
        for key in sorted(children):
            if key.startswith("__"):
                continue
            state = traverse_module(children[key], (f"{path}.{key}", state), update_cb, target_types)
    elif isinstance(m, dict):
        for k in sorted(m):
            state = traverse_module(m[k], (f"{path}['{k}']", state), update_cb, target_types)
    return state


def leaf_components(m: nn.Module) -> Dict[Path, LeafComponent]:
    """Maps paths that start with the class name, such as
    ``SVGP.kernel.variance``, to the module's Parameters, in traversal order
    (``gpflow_tpu/utilities/traversal.py:74-84``)."""

    def _collect(leaf: Any, path: Path, state: Dict[Path, LeafComponent]) -> Dict[Path, LeafComponent]:
        if isinstance(leaf, Parameter):
            state[path] = leaf
        return state

    return traverse_module(m, (type(m).__name__, {}), _collect, (Parameter, nn.Module))


_LIST_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def _jax_path(name: str) -> str:
    """``named_modules``' ``kernel.kernels.0.variance`` as the JAX package
    writes it, ``.kernel.kernels[0].variance``: an all-digit segment is an
    ``nn.ModuleList`` index (``traversal.py:67-70``)."""
    return _LIST_INDEX.sub(r"[\1]", f".{name}")


def parameter_dict(m: nn.Module) -> Dict[str, Parameter]:
    """Maps paths such as ``.kernel.lengthscales`` or
    ``.kernel.kernels[0].variance`` to the module's Parameters, in the JAX
    package's path format (``traversal.py:89-93``)."""
    return {_jax_path(name): p for name, p in m.named_modules() if isinstance(p, Parameter)}


def select_dict_parameters_with_prior(m: nn.Module) -> Dict[str, Parameter]:
    """The Parameters that carry a prior, keyed by path (``traversal.py:117-119``)."""
    return {k: p for k, p in parameter_dict(m).items() if p.prior is not None}


def read_values(m: nn.Module) -> Dict[str, np.ndarray]:
    """Constrained parameter values as numpy arrays, keyed by path."""
    return {k: p.numpy() for k, p in parameter_dict(m).items()}


def load_jax_values(model: nn.Module, values: Mapping[str, Any]) -> None:
    """Assigns constrained values, keyed by path, into ``model``: exactly the
    dict that ``gpflow_tpu.utilities.read_values(jax_model)`` returns for the
    counterpart JAX model. Each value is cast to its parameter's dtype and
    device.

    Atomic: an unknown path, a missing path, a shape mismatch or a value
    outside a parameter's domain raises before any parameter changes."""
    params = parameter_dict(model)
    unknown = sorted(set(values) - set(params))
    missing = sorted(set(params) - set(values))
    if unknown or missing:
        raise KeyError(f"paths do not match the model: unknown {unknown}, missing {missing}")
    prepared = [(params[path], params[path]._prepare_assign(np.asarray(v))) for path, v in values.items()]
    for p, unconstrained in prepared:
        p._set_unconstrained(unconstrained)


def multiple_assign(m: nn.Module, vars_dict: Mapping[str, Any]) -> None:
    """Assigns constrained values to the parameters at some of ``m``'s paths
    (``traversal.py:101-114``). Atomic: every path and value is checked (an
    unknown path raises ``KeyError``; a wrong shape, NaN or a value outside
    a parameter's domain raises ``ValueError``) before the first parameter
    changes."""
    params = parameter_dict(m)
    prepared = []
    for path, value in vars_dict.items():
        if path not in params:
            raise KeyError(f"No parameter at path {path!r}; available: {sorted(params)}")
        prepared.append((params[path], params[path]._prepare_assign(value)))
    for p, unconstrained in prepared:
        p._set_unconstrained(unconstrained)


def reset_cache_bijectors(input_module: M) -> M:
    """Returns the module (``traversal.py:122-127``): the port's bijectors
    keep no cache to clear before a copy."""
    return input_module


def deepcopy(m: M, memo: Optional[Dict[int, Any]] = None) -> M:
    """A deep copy of a module tree (``traversal.py:130-134``)."""
    return _copy.deepcopy(reset_cache_bijectors(m), memo)


def freeze(m: M) -> M:
    """A deep copy of ``m`` with every parameter non-trainable
    (``traversal.py:137-147``)."""
    frozen = deepcopy(m)
    for p in frozen.modules():
        if isinstance(p, Parameter):
            p.trainable = False
    return frozen


def _host_values(params: Sequence[Parameter]) -> List[np.ndarray]:
    """The constrained values of ``params`` as numpy arrays of their own
    dtypes, read from the device in one copy (through float64, which holds
    every float32 and bfloat16 value exactly)."""
    if not params:
        return []
    with torch.no_grad():
        values = [p.value for p in params]
        device = values[0].device
        flat = torch.cat([v.reshape(-1).to(device=device, dtype=torch.float64) for v in values]).cpu().numpy()
    out, start = [], 0
    for v in values:
        n = v.numel()
        out.append(flat[start:start + n].astype(_numpy_dtype(v.dtype)).reshape(tuple(v.shape)))
        start += n
    return out


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _format_value(arr: np.ndarray) -> str:
    if arr.size == 1:
        return f"{arr.reshape(())}"
    return np.array2string(arr, precision=5, threshold=8)


def tabulate_module_summary(m: nn.Module, tablefmt: Optional[str] = None) -> str:
    """The parameter table: name, class, transform, prior, trainable, shape,
    dtype (as numpy names it) and value (``gpflow_tpu/utilities/traversal.py:160-186``),
    in ``tablefmt`` (default: ``config.default_summary_fmt()``, or "simple"
    where that is None). The values come to the host in one copy."""
    components = leaf_components(m)
    headers = ["name", "class", "transform", "prior", "trainable", "shape", "dtype", "value"]
    rows = [
        [
            path,
            "Parameter",
            p.transform.name,
            p.prior.name if p.prior is not None else "",
            str(p.trainable),
            str(tuple(p.shape)),
            value.dtype.name,
            _format_value(value),
        ]
        for (path, p), value in zip(components.items(), _host_values(list(components.values())))
    ]
    try:
        from tabulate import tabulate
    except ImportError:
        return "\n".join("\t".join(r) for r in [headers] + rows)
    fmt = tablefmt if tablefmt is not None else (default_summary_fmt() or "simple")
    return tabulate(rows, headers=headers, tablefmt=fmt)


def print_summary(m: nn.Module, fmt: Optional[str] = None) -> None:
    """Prints the parameter table in ``fmt`` (default:
    ``config.default_summary_fmt()``); "notebook" displays it as HTML
    through IPython (``gpflow_tpu/utilities/traversal.py:189-195``)."""
    if fmt is None:
        fmt = default_summary_fmt()
    if fmt == "notebook":
        from IPython.display import HTML, display

        display(HTML("<pre>" + tabulate_module_summary(m, "html") + "</pre>"))
    else:
        print(tabulate_module_summary(m, fmt))

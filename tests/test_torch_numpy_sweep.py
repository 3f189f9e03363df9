"""A numpy sweep of the public surface (ROADMAP Queue 3, F8-F13): every
function in an ``__all__`` of the JAX package that the port mirrors, and the
public methods of every such class that builds with no argument or with
arguments known by name, called with numpy arguments known by name, in both
packages. Where the JAX package accepts the call, the port must too, unless
its tensor route raises the same way (then the difference is not about
numpy: a label out of range, a matrix of the wrong rank).

The arguments are small float64 arrays drawn from a seed, one per argument
name (``ARGUMENTS``); a callable with an argument of another name, or with
no array argument, is left out. The sweep makes 216 calls; a floor
keeps it from shrinking unseen.
"""
import importlib
import inspect
import pkgutil
import warnings

import numpy as np
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu_torch import config
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

_rs = np.random.RandomState(0)
N, M, D, L = 5, 4, 2, 2


def _spd(n):
    A = _rs.randn(n, n)
    return A @ A.T + n * np.eye(n)


ARGUMENTS = {
    "X": _rs.randn(N, D), "Xnew": _rs.randn(N, D), "X2": _rs.randn(3, D), "Z": _rs.randn(M, D),
    "x": _rs.randn(N), "Y": _rs.randn(N, 1), "F": _rs.randn(N, 1), "Fmu": _rs.randn(N, 1),
    "Fvar": _rs.rand(N, 1) + 0.1, "mean": _rs.randn(N, 1), "var": _rs.rand(N, 1) + 0.1, "mu": _rs.randn(N, 1),
    "Kmn": _rs.randn(M, N), "Kmm": _spd(M), "Knn": _rs.rand(N) + 1, "f": _rs.randn(M, 1),
    "q_mu": _rs.randn(M, L), "q_sqrt": np.tril(_rs.randn(L, M, M)) + 2 * np.eye(M), "K": _spd(M), "A": _spd(M),
    "L": np.linalg.cholesky(_spd(M)), "matrix": _spd(M), "B": _rs.randn(M, 2), "value": _rs.randn(3),
    "a": _rs.randn(3), "b": _rs.randn(3), "lengthscales": np.array([0.5, 1.0]), "variance": np.array(1.3),
    "Xs": _rs.randn(N, D), "Zs": _rs.randn(M, D), "nat1": _rs.randn(M, 1), "nat2": -_spd(M)[None],
    "eta1": _rs.randn(M, 1), "eta2": _spd(M)[None], "varsqrt": np.linalg.cholesky(_spd(M))[None],
    "Fmean": _rs.randn(N, 1), "means": _rs.randn(N, 2), "covs": np.stack([_spd(2)] * N),
    "S": np.stack([_spd(2)] * N), "cov": _spd(M), "Lcov": np.linalg.cholesky(_spd(M)), "num_samples": 3,
    "H": 5, "n_gh": 5, "dim": 1, "W": _rs.randn(3, L), "g": _rs.randn(N, 1), "v": _rs.randn(N, 1),
    "y": _rs.randn(N, 1), "vec": _rs.randn(6), "data": _rs.randn(N, 3), "latent_dim": 1, "jitter": 1e-6,
    "n": 4, "N": 4, "size": 6, "num_classes": 3,
}
# Modules whose public names take no arrays the sweep could guess, or that
# need a process group, a writer or a file.
SKIPPED_MODULES = ("parallel", "monitor", "utilities.profiling", "utilities.serving", "experimental")
SKIPPED_NAMES = ("config", "as_context", "print_summary", "training_loop", "run_hmc", "profile")
CALL_FLOOR = 200


def _arguments(signature):
    """The leading arguments of a signature that ``ARGUMENTS`` knows, up to
    the first one with a default that it does not; None where a required
    argument has a name it does not know."""
    args = []
    for p in signature.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.name in ARGUMENTS:
            args.append(ARGUMENTS[p.name])
        elif p.default is inspect.Parameter.empty:
            return None
        else:
            break
    return args


def _instances(cls_jax, cls_port):
    """An instance of each package's class, built with no argument or with
    arguments known by name; None where neither builds."""
    for make in (lambda: [], lambda: _arguments(inspect.signature(cls_jax))):
        try:
            args = make()
            if args is not None:
                return cls_jax(*args), cls_port(*args)
        except Exception:  # a class that needs other arguments: left out
            pass
    return None


def _callables():
    """(label, JAX callable, port callable) for each public function and each
    public method of each public class that builds."""
    names = ["gpflow_tpu"] + [m.name for m in pkgutil.walk_packages(gpflow_tpu.__path__, "gpflow_tpu.")]
    seen = set()
    for name in names:
        if name[len("gpflow_tpu."):].startswith(SKIPPED_MODULES):
            continue
        module_jax = importlib.import_module(name)
        module_port = importlib.import_module("gpflow_tpu_torch" + name[len("gpflow_tpu"):])
        for attr in getattr(module_jax, "__all__", []):
            obj_jax, obj_port = getattr(module_jax, attr, None), getattr(module_port, attr, None)
            if obj_jax is None or obj_port is None or id(obj_jax) in seen or attr in SKIPPED_NAMES:
                continue
            if attr.startswith("set_"):
                continue
            seen.add(id(obj_jax))
            if inspect.isclass(obj_jax):
                pair = _instances(obj_jax, obj_port)
                if pair is None:
                    continue
                for method in ["__call__"] + [m for m in dir(obj_jax) if not m.startswith("_")]:
                    try:
                        bound_jax, bound_port = getattr(pair[0], method, None), getattr(pair[1], method, None)
                    except Exception:  # a property that raises on this instance
                        continue
                    if callable(bound_jax) and bound_port is not None and not inspect.isclass(bound_jax):
                        yield f"{name}.{attr}.{method}", bound_jax, bound_port
            elif callable(obj_jax):
                yield f"{name}.{attr}", obj_jax, obj_port


def _tensors(args):
    return [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]


def test_numpy_is_accepted_wherever_the_jax_package_accepts_it():
    calls, faults = 0, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, fn_jax, fn_port in _callables():
            try:
                args = _arguments(inspect.signature(fn_jax))
            except (TypeError, ValueError):  # no signature to read
                continue
            if args is None or not any(isinstance(a, np.ndarray) for a in args):
                continue
            try:
                fn_jax(*[np.array(a) if isinstance(a, np.ndarray) else a for a in args])
            except Exception:  # the JAX package refuses these arguments: no claim
                continue
            calls += 1
            try:
                fn_port(*[np.array(a) if isinstance(a, np.ndarray) else a for a in args])
            except Exception as numpy_error:
                try:
                    fn_port(*_tensors(args))
                except Exception:  # the tensor route refuses them too: not about numpy
                    continue
                faults.append(f"{label}: {type(numpy_error).__name__}: {str(numpy_error).splitlines()[0][:200]}")
    assert not faults, "\n".join(faults)
    assert calls >= CALL_FLOOR, calls

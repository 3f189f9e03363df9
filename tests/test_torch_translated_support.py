"""What the translated JAX test files share (``tests/test_torch_translated_<stem>.py``).

Each of those files is one of the JAX package's test files that import jax
or optax, with the JAX idioms replaced one for one and nothing else changed:
the same numpy draws, oracles, tolerances, test names and ids. This module
holds the replacements:

* ``DEVICE``: the device the files build on, named by
  ``GPFLOW_TPU_TORCH_REFERENCE_DEVICE`` ("cpu" unless set), so that the same
  files run on the card;
* ``X64``, the keywords that make ``torch.ones``, ``torch.eye`` and the like
  build what ``jnp.ones``, ``jnp.eye`` and the like build;
* ``asarray`` for ``jnp.asarray``: a tensor on ``DEVICE`` that keeps a numpy
  array's dtype, and takes Python numbers and lists as float64 (the JAX
  package's tests run with x64 on);
* ``seeded_generator`` for a PRNG key, which the port's samplers take as
  ``generator=``;
* ``polyval`` for ``jnp.polyval`` and ``solve_triangular`` for
  ``jax.scipy.linalg.solve_triangular``;
* ``grad`` and ``value_and_grad`` for ``jax.grad`` and
  ``jax.value_and_grad``, through ``torch.autograd.grad``;
* ``adam`` and ``sgd`` for ``optax.adam`` and ``optax.sgd``: ``torch.optim.Adam``
  and ``torch.optim.SGD`` with the same learning rate, behind optax's
  ``init`` and ``update``;
* ``translated_test_environment``, an autouse fixture of module scope that
  each file imports, so that it holds for the file's module fixtures too:
  the shape checks on, as ``tests/conftest.py`` turns
  them on for the JAX package, and ``np.asarray`` of a tensor read through
  ``.detach().cpu()``, as the conformance plugin does (ROADMAP Queue 3, "the
  output side of F3"), with one thread of torch's pool: the JAX tests'
  arrays are small, and the suite's other workers run beside them.

A JAX test that the port cannot meet by design carries ``deviation(name)``:
a strict xfail whose reason names a deviation of ROADMAP Queue 3 (the rows
of ``DEVIATIONS``), so that the case fails while the deviation stands and
fails the run once it does not.

It holds no test.
"""
import os

import numpy as np
import pytest
import torch

from gpflow_tpu_torch import config
from gpflow_tpu_torch.utilities.shapes import get_enable_check_shapes, set_enable_check_shapes

from .test_torch_reference_plugin import DEVICE_VARIABLE

DEVICE = torch.device(os.environ.get(DEVICE_VARIABLE, "cpu"))
config.set_default_device(DEVICE.type)
# A tensor factory's keywords for what ``jnp.ones``, ``jnp.eye`` and the
# like build: float64 (x64 is on) on DEVICE.
X64 = {"dtype": torch.float64, "device": DEVICE}

# ROADMAP Queue 3's deviations that the translated tests meet, by name.
DEVIATIONS = {
    "the draws": (
        "the port draws from a torch.Generator, and nothing is traced: equal inputs do not give equal draws, "
        "and a call without a generator is never refused"
    ),
}


def deviation(name):
    """The mark of a JAX test that fails on the port as the deviation
    ``name`` says."""
    return pytest.mark.xfail(strict=True, reason=f"deviation {name}: {DEVIATIONS[name]}")


_TENSOR_ARRAY = torch.Tensor.__array__


def _tensor_array(tensor, *args, **kwargs):
    return _TENSOR_ARRAY(tensor.detach().cpu(), *args, **kwargs)


@pytest.fixture(scope="module", autouse=True)
def translated_test_environment():
    array, checks, threads = torch.Tensor.__array__, get_enable_check_shapes(), torch.get_num_threads()
    torch.Tensor.__array__ = _tensor_array
    set_enable_check_shapes(True)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_enable_check_shapes(checks)
    torch.Tensor.__array__ = array


def asarray(value):
    """``jnp.asarray``: a tensor passes through; anything else becomes a
    tensor on ``DEVICE`` in its numpy dtype."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value), device=DEVICE)


def solve_triangular(a, b, lower=False):
    """``jax.scipy.linalg.solve_triangular`` (no transposes)."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def seeded_generator(seed):
    """A PRNG key (``jax.random.PRNGKey(seed)``): a ``torch.Generator`` on
    ``DEVICE`` seeded with ``seed`` (ROADMAP Queue 3, "The draws")."""
    return torch.Generator(device=DEVICE).manual_seed(seed)


def polyval(coeffs, x):
    """``jnp.polyval``: the polynomial of ``coeffs`` (highest power first) at
    ``x``, by Horner's rule."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + c
    return out


class _TorchOptimizer:
    """An optax-style (``init``, ``update``) pair over a ``torch.optim``
    optimizer: ``update`` steps the optimizer on copies of the parameters
    and returns the change of each, which the caller adds, as optax's
    updates are added."""

    def __init__(self, cls, learning_rate):
        self.cls, self.learning_rate = cls, learning_rate

    def init(self, params):
        leaves = [asarray(p).detach().clone() for p in params]
        return leaves, self.cls(leaves, lr=self.learning_rate)

    def update(self, grads, state, params=None):
        leaves, optimizer = state
        before = [leaf.clone() for leaf in leaves]
        for leaf, g in zip(leaves, grads):
            leaf.grad = g.detach()
        optimizer.step()
        return tuple(leaf.detach() - b for leaf, b in zip(leaves, before)), state


def adam(learning_rate):
    """``optax.adam``: ``torch.optim.Adam`` with the same learning rate (and
    the same defaults: betas (0.9, 0.999), eps 1e-8)."""
    return _TorchOptimizer(torch.optim.Adam, learning_rate)


def sgd(learning_rate):
    """``optax.sgd``: ``torch.optim.SGD`` with the same learning rate."""
    return _TorchOptimizer(torch.optim.SGD, learning_rate)


def _leaf(value):
    return asarray(value).detach().clone().requires_grad_(True)


def value_and_grad(fun):
    """``jax.value_and_grad`` of a function of one argument: a tensor or an
    array, or a tuple or list of them."""

    def wrapped(arg, *args, **kwargs):
        leaves = [_leaf(a) for a in arg] if isinstance(arg, (tuple, list)) else [_leaf(arg)]
        value = fun(type(arg)(leaves) if isinstance(arg, (tuple, list)) else leaves[0], *args, **kwargs)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return value.detach(), (type(arg)(grads) if isinstance(arg, (tuple, list)) else grads[0])

    return wrapped


def grad(fun):
    """``jax.grad`` of a function of one argument."""
    both = value_and_grad(fun)
    return lambda *args, **kwargs: both(*args, **kwargs)[1]

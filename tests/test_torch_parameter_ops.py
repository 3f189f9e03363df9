"""``Parameter`` as an array in arithmetic (ROADMAP F5), against the JAX
package's ``Parameter`` (``gpflow_tpu/base.py:355-442``), on the CPU in
float64 from the same seeded numpy values.

Every operator on both sides (a Python number, a numpy array, a tensor or
another Parameter as the other operand) gives the JAX package's value to
float64 round-off. Gradients through ``p * x``, ``x - p`` and ``p @ x``
match the JAX VJP. A numpy left operand defers to the reflected operator
and returns a tensor that carries the gradient. ``==`` stays identity-based
(a written deviation): ``p in [p]``, ``{p}`` and module registration work.
"""
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import gpflow_tpu
from gpflow_tpu_torch import Parameter, config
from gpflow_tpu_torch.utilities import positive
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-13
rng = np.random.RandomState(17)
VECTOR = rng.rand(3) + 0.5
MATRIX = rng.randn(3, 3)
OTHER = rng.rand(3) + 0.25


def _pair(value=VECTOR):
    """The same constrained value in both packages, under a softplus."""
    return (
        gpflow_tpu.Parameter(value, transform=gpflow_tpu.utilities.positive()),
        Parameter(value, transform=positive()),
    )


def _close(got, want):
    assert isinstance(got, torch.Tensor), type(got)
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.max(np.abs(want)), 1e-300))


BINARY = {
    "add": operator.add,
    "sub": operator.sub,
    "mul": operator.mul,
    "truediv": operator.truediv,
    "pow": operator.pow,
    "lt": operator.lt,
    "le": operator.le,
    "gt": operator.gt,
    "ge": operator.ge,
}
OPERANDS = {
    "python": lambda: 1.7,
    "numpy": lambda: OTHER,
    "tensor": lambda: torch.tensor(OTHER),
}


@pytest.mark.parametrize("operand", sorted(OPERANDS))
@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_operator_on_both_sides(name, operand):
    op = BINARY[name]
    jp, tp = _pair()
    other = OPERANDS[operand]()
    jax_other = 1.7 if operand == "python" else jnp.asarray(OTHER)
    _close(op(tp, other), op(jp, jax_other))
    _close(op(other, tp), op(jax_other, jp))


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_operator_between_parameters(name):
    op = BINARY[name]
    jp, tp = _pair()
    jq, tq = _pair(OTHER)
    _close(op(tp, tq), op(jp, jq))


@pytest.mark.parametrize("operand", ["numpy", "tensor"])
def test_matmul_on_both_sides(operand):
    jp, tp = _pair(np.abs(MATRIX) + 0.1)
    other = MATRIX if operand == "numpy" else torch.tensor(MATRIX)
    _close(tp @ other, jp @ jnp.asarray(MATRIX))
    _close(other @ tp, jnp.asarray(MATRIX) @ jp)
    _close(tp @ VECTOR, jp @ jnp.asarray(VECTOR))


def test_unary_operators_indexing_and_len():
    jp, tp = _pair()
    _close(-tp, -jp)
    _close(abs(tp), abs(jp))
    _close(tp[1], jp[1])
    _close(tp[1:], jp[1:])
    assert len(tp) == len(jp) == 3
    _close(torch.stack(list(tp)), jnp.stack(list(jp)))


def test_numpy_on_the_left_returns_a_tensor_with_the_gradient():
    _, tp = _pair()
    out = OTHER - tp
    assert isinstance(out, torch.Tensor) and out.requires_grad
    out.sum().backward()
    assert tp.unconstrained.grad is not None
    # numpy's own functions still read the value through __array__
    np.testing.assert_allclose(np.exp(tp), np.exp(VECTOR), rtol=RTOL)


def _jax_grad(fn, value):
    """d/du sum(fn(softplus(u))) at the u of ``value``, by the JAX VJP."""
    unconstrained = gpflow_tpu.utilities.positive().inverse(jnp.asarray(value))
    constrained = lambda u: gpflow_tpu.utilities.positive().forward(u)  # noqa: E731
    return jax.grad(lambda u: jnp.sum(fn(constrained(u))))(unconstrained)


@pytest.mark.parametrize(
    "case",
    ["p * x", "x - p", "p @ x"],
)
def test_gradient_matches_the_jax_vjp(case):
    value, x = (np.abs(MATRIX) + 0.1, MATRIX) if case == "p @ x" else (VECTOR, OTHER)
    fn = {"p * x": lambda p: p * x, "x - p": lambda p: x - p, "p @ x": lambda p: p @ x}[case]
    _, tp = _pair(value)
    fn(tp).sum().backward()
    _close(tp.unconstrained.grad, _jax_grad(fn, value))


def test_equality_stays_identity_and_modules_register():
    _, tp = _pair()
    _, tq = _pair()
    assert tp == tp and tp != tq and not (tp == tq)
    assert tp in [tq, tp] and tq not in [tp]
    assert {tp, tq} == {tq, tp} and len({tp, tp}) == 1
    holder = nn.Module()
    holder.a, holder.b = tp, tq
    assert list(holder.children()) == [tp, tq]
    assert len(list(holder.parameters())) == 2


def test_other_device_raises_as_torch_does():
    _, tp = _pair()
    with pytest.raises((RuntimeError, NotImplementedError)):
        tp + torch.ones(3, device="meta").to(torch.float64)

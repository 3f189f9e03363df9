"""The faults of ``base.Module`` and ``base.Parameter`` that the translated JAX
tests found (ROADMAP Queue 3, F17-F19), each held to the JAX package on the
same inputs:

* F17: a Parameter or Module held in a list, tuple or dict attribute of a
  Module is one of its ``all_parameters`` (the JAX package's
  ``parameters``), so ``trainable_parameters``, ``set_trainable`` and an
  optimizer see it;
* F18: ``Parameter(shape=..., unconstrained_shape=...)`` raises
  AssertionError, as the JAX package's assert does;
* F19: ``Parameter(Parameter)`` takes the source's constrained value and
  inherits its transform and name as well as its prior, ``prior_on`` and
  trainability.
"""
from collections import OrderedDict

import numpy as np
import pytest
import torch

import gpflow_tpu as gj
import gpflow_tpu_torch as gt
from gpflow_tpu_torch import config
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU


def _containers(pkg):
    """A module whose Parameters sit in containers at several depths, with
    static entries beside them, and one registered directly."""
    base = pkg.base.Module

    class Holder(base):
        def __init__(self):
            if isinstance(self, torch.nn.Module):
                super().__init__()
            self.direct = pkg.Parameter(0.5, name="direct")
            self.items = [pkg.Parameter(1.0, name="p0"), "label", 3]
            self.table = {"p": pkg.Parameter(2.0, name="p1"), "mode": "fast"}
            self.pair = (pkg.Parameter(4.0, name="p2"), None)
            self.nested = OrderedDict([("inner", [{"deep": pkg.Parameter(5.0, transform=pkg.bijectors.Exp(),
                                                                      name="p3")}])])
            self.kernels = [pkg.kernels.SquaredExponential()]

    return Holder()


def _names(params):
    return sorted(p.name for p in params)


def test_parameters_in_containers_are_found():
    port, jax_module = _containers(gt), _containers(gj)
    assert _names(port.all_parameters) == _names(jax_module.parameters)
    assert len(port.all_parameters) == 7  # 5 named, the kernel's variance and lengthscales
    assert _names(port.trainable_parameters) == _names(jax_module.trainable_parameters)


def test_set_trainable_reaches_parameters_in_containers():
    port, jax_module = _containers(gt), _containers(gj)
    gt.set_trainable(port, False)
    gj.set_trainable(jax_module, False)
    assert port.trainable_parameters == () and len(jax_module.trainable_parameters) == 0
    gt.set_trainable(port, True)
    assert len(port.trainable_parameters) == 7


def test_a_parameter_in_a_container_is_trained():
    """Autograd through ``trainable_variables`` reaches the container's
    Parameter, as JAX's gradient over the pytree does."""
    port = _containers(gt)
    loss = port.items[0].value ** 2 + port.nested["inner"][0]["deep"].value
    grads = torch.autograd.grad(loss, [p.unconstrained for p in port.trainable_variables], allow_unused=True)
    by_name = {p.name: g for p, g in zip(port.trainable_variables, grads)}
    np.testing.assert_allclose(float(by_name["p0"]), 2.0)
    np.testing.assert_allclose(float(by_name["p3"]), 5.0, rtol=1e-12)  # d exp(u) / du at exp(u) = 5


def test_shape_with_unconstrained_shape_raises_assertion_error():
    for pkg in (gt, gj):
        with pytest.raises(AssertionError, match="Cannot set both"):
            pkg.Parameter(np.ones(3), shape=(3,), unconstrained_shape=(3,))
        with pytest.raises(AssertionError, match="Cannot set both"):
            pkg.Parameter(np.ones(3), shape=(3,), constrained_shape=(3,))


@pytest.mark.parametrize("override", [False, True])
def test_copy_construction_inherits_transform_and_name(override):
    def build(pkg):
        src = pkg.Parameter(2.0, transform=pkg.utilities.positive(), prior=pkg.priors.Gamma(2.0, 3.0),
                            prior_on="unconstrained", trainable=False, name="src")
        kwargs = {"transform": pkg.bijectors.Exp(), "name": "other", "trainable": True} if override else {}
        return src, pkg.Parameter(src, **kwargs)

    (src, cp), (jsrc, jcp) = build(gt), build(gj)
    assert type(cp.transform).__name__ == type(jcp.transform).__name__
    assert (cp.transform is src.transform) == (jcp.transform is jsrc.transform) == (not override)
    assert cp.name == jcp.name and cp.trainable == jcp.trainable and cp.prior_on.value == jcp.prior_on.value
    np.testing.assert_allclose(cp.numpy(), np.asarray(jcp.value), rtol=1e-12)
    np.testing.assert_allclose(cp.unconstrained.detach().numpy(), np.asarray(jcp.unconstrained_variable),
                               rtol=1e-12)

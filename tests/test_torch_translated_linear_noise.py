"""The JAX package's ``tests/integration/test_linear_noise.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Input-dependent (heteroskedastic linear) noise through the
parameter-or-function machinery (reference
tests/integration/test_linear_noise.py analog).
"""
import numpy as np

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch import kernels, likelihoods
from gpflow_tpu_torch.functions import Linear
from gpflow_tpu_torch.models import SVGP
from . import test_torch_translated_support as support
from .test_torch_translated_support import translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def test_svgp_with_linear_noise_function_trains():
    N = 128
    X = np.linspace(0.1, 2.0, N)[:, None]
    noise_scale = 0.05 + 0.2 * X  # noise grows with X
    Y = np.sin(3 * X) + noise_scale * rng.randn(N, 1)

    likelihood = likelihoods.Gaussian(scale=Linear(A=np.array([[0.1]]), b=np.array([0.1])))
    model = SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=likelihood,
        inducing_variable=X[::8].copy(),
        num_data=N,
    )

    # the scale Function's A and b must be trainable parameters of the model
    names = [p.name for p in model.trainable_parameters]
    assert sum(isinstance(p, gpf.Parameter) for p in model.trainable_parameters) == len(names)

    loss0 = float(model.training_loss((X, Y)))
    opt = support.adam(0.05)
    params = list(model.trainable_parameters)

    def loss_fn(unc):
        old = [p.unconstrained for p in params]
        try:
            for p, u in zip(params, unc):
                p._parameters["unconstrained"] = u
            return model.training_loss((X, Y))
        finally:
            for p, o in zip(params, old):
                p._parameters["unconstrained"] = o

    unc = tuple(p.unconstrained for p in params)
    state = opt.init(unc)
    def step(unc, state):
        loss, g = support.value_and_grad(loss_fn)(unc)
        upd, state = opt.update(g, state, unc)
        return tuple(u + du for u, du in zip(unc, upd)), state, loss

    for _ in range(100):
        unc, state, loss = step(unc, state)
    for p, u in zip(params, unc):
        p.assign_unconstrained(u)

    assert float(loss) < loss0 - 10

    # the learned noise must actually vary with X: check variance_at ends
    v_low = float(np.asarray(likelihood.variance_at(np.array([[0.1]]))).squeeze())
    v_high = float(np.asarray(likelihood.variance_at(np.array([[2.0]]))).squeeze())
    assert v_high > v_low


def test_variance_at_constant_parameter_broadcasts():
    lik = likelihoods.Gaussian(0.3)
    v = np.asarray(lik.variance_at(np.zeros((7, 2))))
    np.testing.assert_allclose(np.broadcast_to(v, (7, 1)), 0.3, rtol=1e-12)

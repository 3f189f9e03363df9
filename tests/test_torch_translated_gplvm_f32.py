"""The JAX package's ``tests/gpflow_tpu/models/test_gplvm_f32.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

BayesianGPLVM float32 robustness: the f32 psi2 projection must be PSD
(no NaN Cholesky) and match the f64 bound closely at evaluation.
"""
import numpy as np

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch.models import BayesianGPLVM
from gpflow_tpu_torch.utilities.ops import pca_reduce
from . import test_torch_translated_support as support
from .test_torch_translated_support import DEVICE, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)
N, Q, D, M = 200, 2, 6, 32
t = rng.randn(N, Q)
Y64 = np.tanh(t @ rng.randn(Q, D)) + 0.05 * rng.randn(N, D)


def _model(dtype):
    Y = Y64.astype(dtype)
    Xinit = np.asarray(pca_reduce(Y, Q)).astype(dtype)
    return BayesianGPLVM(
        Y,
        X_data_mean=Xinit,
        X_data_var=np.full((N, Q), 0.1, dtype),
        kernel=gpf.kernels.SquaredExponential(lengthscales=np.ones(Q, dtype)),
        num_inducing_variables=M,
    )


def test_f32_elbo_finite_and_close_to_f64():
    with gpf.config.as_context(
        gpf.config.Config(float=np.float32, jitter=1e-4, device=DEVICE.type)
    ):
        m32 = _model(np.float32)
        l32 = float(m32.training_loss())
        g = support.grad(
            lambda u: _swap_loss(m32, u)
        )(tuple(p.unconstrained for p in m32.trainable_parameters))
    m64 = _model(np.float64)
    l64 = float(m64.training_loss())
    assert np.isfinite(l32)
    # jitter differs (1e-4 vs 1e-6) and precision differs: generous tolerance
    assert abs(l32 - l64) / abs(l64) < 0.05
    for gi in g:
        assert np.isfinite(np.asarray(gi)).all()


def _swap_loss(model, unc):
    params = list(model.trainable_parameters)
    old = [p.unconstrained for p in params]
    try:
        for p, u in zip(params, unc):
            p._parameters["unconstrained"] = u
        return model.training_loss()
    finally:
        for p, o in zip(params, old):
            p._parameters["unconstrained"] = o

"""SGPR and GPRFITC of gpflow_tpu_torch against gpflow_tpu on the CPU, in
float64: the SGPR ELBO, the Titsias upper bound and the GPRFITC objective
with their gradients against ``jax.grad``, ``compute_qu``, ``predict_f``
with both ``full_cov`` values, the cached and fused ``SGPRPosterior``,
``load_jax_values``, and ``to_default_float``. Unless a test states
otherwise, the port agrees to 1e-10 relative to the largest entry."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, posteriors
from gpflow_tpu_torch import models as port_models
from gpflow_tpu_torch.ops import launch_counts
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, to_default_float
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

N, M, D, NEW = 200, 20, 2, 30
KERNELS = ("SquaredExponential", "Matern52")
RTOL = 1e-10


def _data(seed=0, P=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, D) * 3.0
    Y = np.sin(3.0 * X[:, :1]) + 0.1 * rng.randn(N, P)
    Z = X[rng.permutation(N)[:M]].copy()
    Xnew = rng.rand(NEW, D) * 3.0
    return X, Y, Z, Xnew


def _models(cls, kernel="SquaredExponential", seed=0, P=1, **kwargs):
    X, Y, Z, Xnew = _data(seed, P)
    args = dict(inducing_variable=Z, noise_variance=0.1, **kwargs)
    jm = getattr(gpflow_tpu.models, cls)(
        (X, Y), kernel=getattr(gpflow_tpu.kernels, kernel)(variance=1.3, lengthscales=[0.7, 1.2]), **args
    )
    pm = getattr(port_models, cls)(
        (X, Y), kernel=getattr(kernels, kernel)(variance=1.3, lengthscales=[0.7, 1.2]), **args
    )
    return jm, pm, Xnew


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _jax_value_and_grads(jm, objective):
    paths = sorted(p for p, v in jax_parameter_dict(jm).items() if v.trainable)
    params = [jax_parameter_dict(jm)[p] for p in paths]
    value, grads = reference_jit(jax.value_and_grad(functionalize(lambda: objective(jm), params)))(
        tuple(p.unconstrained_variable for p in params)
    )
    return value, dict(zip(paths, grads))


def _port_value_and_grads(pm, objective):
    params = {path: p for path, p in parameter_dict(pm).items() if p.trainable}
    value = objective(pm)
    grads = torch.autograd.grad(value, [p.unconstrained for p in params.values()])
    return value.detach(), dict(zip(params, grads))


# training_loss is -(elbo) for SGPR and -(fitc_log_marginal_likelihood) for
# GPRFITC, with a zero log prior density
OBJECTIVES = {
    "SGPR training_loss": ("SGPR", lambda m: m.training_loss()),
    "SGPR upper_bound": ("SGPR", lambda m: m.upper_bound()),
    "GPRFITC training_loss": ("GPRFITC", lambda m: m.training_loss()),
}


@pytest.mark.parametrize(
    "objective,kernel,P",
    [("SGPR training_loss", kernel, P) for kernel in KERNELS for P in (1, 2)]
    + [("SGPR upper_bound", "SquaredExponential", 1), ("SGPR upper_bound", "Matern52", 2),
       ("GPRFITC training_loss", "SquaredExponential", 2), ("GPRFITC training_loss", "Matern52", 1)],
)
def test_objective_and_gradient_match_jax_f64(objective, kernel, P):
    cls, fn = OBJECTIVES[objective]
    jm, pm, _ = _models(cls, kernel, P=P)
    want_value, want = _jax_value_and_grads(jm, fn)
    got_value, got = _port_value_and_grads(pm, fn)
    assert got.keys() == want.keys() == {
        ".inducing_variable.Z", ".kernel.lengthscales", ".kernel.variance", ".likelihood.variance"
    }
    _close(got_value, want_value)
    for path in want:
        _close(got[path], want[path])


def test_elbo_is_below_the_upper_bound():
    _, pm, _ = _models("SGPR")
    with torch.no_grad():
        elbo = pm.elbo()
        assert float(elbo) <= float(pm.upper_bound())
        assert float(elbo) == -float(pm.training_loss()) == float(pm.maximum_log_likelihood_objective())
    _, fitc, _ = _models("GPRFITC")
    with torch.no_grad():
        assert float(fitc.fitc_log_marginal_likelihood()) == -float(fitc.training_loss())


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("cls", ["SGPR_deprecated", "SGPR", "GPRFITC"])
def test_predict_f_matches_jax_f64(cls, full_cov):
    jm, pm, Xnew = _models(cls, seed=1, P=2)
    want = jm.predict_f(Xnew, full_cov=full_cov)
    with torch.no_grad():
        got = pm.predict_f(torch.from_numpy(Xnew), full_cov=full_cov)
    expected = (NEW, 2) if not full_cov else (2, NEW, NEW)
    assert tuple(got[1].shape) == expected
    for g, w in zip(got, want):
        _close(g, w)


def test_predict_y_and_log_density_match_jax_f64():
    jm, pm, Xnew = _models("SGPR", seed=2)
    Ynew = np.sin(3.0 * Xnew[:, :1])
    with torch.no_grad():
        x, y = torch.from_numpy(Xnew), torch.from_numpy(Ynew)
        for g, w in zip(pm.predict_y(x), jm.predict_y(Xnew)):
            _close(g, w)
        _close(pm.predict_log_density((x, y)), jm.predict_log_density((Xnew, Ynew)))


@pytest.mark.parametrize("full_cov", [False, True])
def test_posterior_cached_and_fused_match_jax_f64(full_cov):
    jm, pm, Xnew = _models("SGPR", seed=3, P=2)
    x = torch.from_numpy(Xnew)
    with torch.no_grad():
        post, fused = pm.posterior(), pm.posterior(precompute_cache="nocache")
        got = [post.predict_f(x, full_cov=full_cov), fused.fused_predict_f(x, full_cov=full_cov),
               (post.predict_mean(x),), (fused.predict_mean(x),)]
    jpost = jm.posterior()
    want = [jpost.predict_f(Xnew, full_cov=full_cov), jpost.fused_predict_f(Xnew, full_cov=full_cov),
            (jpost.predict_mean(Xnew),), (jm.posterior(None).predict_mean(Xnew),)]
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            _close(gt, wt)


def test_posterior_cache_holds_l_lb_c_alpha():
    jm, pm, _ = _models("SGPR", seed=4)
    with torch.no_grad():
        cache = pm.posterior().cache
    assert isinstance(pm.posterior(), posteriors.SGPRPosterior)
    assert len(cache) == 4 and pm.posterior(precompute_cache=None).cache is None
    for got, want in zip(cache, jm.posterior().cache):
        _close(got, want)


def test_compute_qu_matches_jax_f64():
    jm, pm, _ = _models("SGPR", seed=5, P=2)
    with torch.no_grad():
        got = pm.compute_qu()
    for g, w in zip(got, jm.compute_qu()):
        _close(g, w)


def test_gprfitc_common_terms_match_jax_f64():
    jm, pm, _ = _models("GPRFITC", seed=6)
    with torch.no_grad():
        got = pm.common_terms()
    for g, w in zip(got, jm.common_terms()):
        _close(g, w)


@pytest.mark.parametrize("cls", ["SGPR", "GPRFITC", "CGLB"])
def test_load_jax_values_carries_a_sparse_model(cls):
    jm, pm, _ = _models(cls, seed=7)
    rng = np.random.RandomState(7)
    values = {".kernel.lengthscales": np.array([0.4, 1.9]), ".kernel.variance": np.array(2.2),
              ".likelihood.variance": np.array(0.03), ".inducing_variable.Z": rng.rand(M, D) * 3.0}
    if cls == "CGLB":
        values["._v"] = rng.randn(1, N)
    gpflow_tpu.utilities.multiple_assign(jm, values)
    load_jax_values(pm, read_values(jm))
    got, want = port_read_values(pm), read_values(jm)
    assert got.keys() == want.keys() == values.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-15)
    if cls != "CGLB":  # CGLB's objective moves v; tests/test_torch_cglb.py compares it
        _close(pm.training_loss().detach(), jm.training_loss(), rtol=1e-12)


def test_noise_variance_and_likelihood_are_exclusive():
    from gpflow_tpu_torch.likelihoods import Gaussian

    X, Y, Z, _ = _data()
    with pytest.raises(ValueError, match="Cannot set both"):
        port_models.SGPR((X, Y), kernels.SquaredExponential(), Z, noise_variance=0.1, likelihood=Gaussian(0.1))
    assert port_models.GPRFITC((X, Y), kernels.SquaredExponential(), Z).likelihood.variance.numpy() == 1.0


def test_num_latent_gps_and_trainable_variables():
    _, pm, _ = _models("SGPR", P=2)
    assert pm.num_latent_gps == 2 and pm.num_data == N
    assert [p.name for p in pm.trainable_variables] == ["variance", "lengthscales", "variance", "Z"]
    assert pm.training_loss_closure()().item() == pm.training_loss().item()


def test_float32_objective_against_float64():
    # float32 against the float64 port (held to the JAX package above), both
    # with the float32 jitter 1e-4. cond(B) for these inputs is below 2e3
    # (asserted): the float32 Cholesky of B and the solves with it carry
    # about cond(B) * eps32 = 2.4e-4 of relative error; Kuu (cond ~1e5)
    # enters the ELBO only through the Nystrom Q, which its rounding moves
    # less. (At bench width, where cond(B) ~ 2e5 makes this bound 2e-2,
    # chip_smoke.py sets its limits from readings instead.)
    X, Y, Z, _ = _data()
    values = {}
    for dtype in (torch.float64, torch.float32):
        with config.as_context(dataclasses.replace(config.config(), float=dtype, jitter=1e-4)):
            pm = port_models.SGPR((X, Y), kernels.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.2]), Z,
                                  noise_variance=0.1).to(dtype)
            with torch.no_grad():
                B = pm._common_calculation().B.double()
                values[dtype] = pm.elbo()
        eig = torch.linalg.eigvalsh(B)
        assert float(eig[-1] / eig[0]) < 2e3
    assert values[torch.float32].dtype == torch.float32
    _close(values[torch.float32].double(), values[torch.float64], rtol=2e3 * float(np.finfo(np.float32).eps))


def test_sparse_models_on_the_cpu_launch_no_kernel():
    before = dict(launch_counts)
    for cls in ("SGPR", "GPRFITC"):
        _, pm, Xnew = _models(cls, seed=8)
        pm.training_loss().backward()
        with torch.no_grad():
            pm.predict_f(torch.from_numpy(Xnew))
    assert launch_counts == before == {"K1": 0, "K2": 0}


def test_to_default_float():
    t = to_default_float(3)
    assert t.dtype == torch.float64 and t.device == config.default_device() and float(t) == 3.0
    with config.as_context(dataclasses.replace(config.config(), float=torch.float32)):
        assert to_default_float(np.arange(3)).dtype == torch.float32
        x = torch.ones(2, dtype=torch.float64)
        assert to_default_float(x).dtype == torch.float32 and to_default_float(x).device == x.device


def test_sparse_models_build_on_the_default_device():
    X, Y, Z, _ = _data()
    for cls in ("SGPR", "GPRFITC", "CGLB"):
        pm = getattr(port_models, cls)((X, Y), kernels.SquaredExponential(), Z, noise_variance=0.1)
        tensors = list(pm.parameters()) + list(pm.data)
        assert {t.device for t in tensors} == {config.default_device()} == {torch.device("cpu")}
    # the card is the default: without one, building raises torch's own
    # error; nothing falls back to the CPU
    with config.as_context(dataclasses.replace(config.config(), device="cuda")):
        if torch.cuda.is_available():
            pm = port_models.CGLB((X, Y), kernels.SquaredExponential(), Z, noise_variance=0.1)
            assert pm.aux_vec.device.type == pm.data[0].device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                port_models.CGLB((X, Y), kernels.SquaredExponential(), Z, noise_variance=0.1)

"""Coregion, ArcCosine and the Multiscale inducing variables of
gpflow_tpu_torch against gpflow_tpu, on the CPU, on the same seeded numpy
inputs and values, in float64 (1e-10 of the largest entry): Coregion's K
and K_diag, with NaN wherever an index falls outside [0, output_dim); an
SVGP with SquaredExponential(active_dims) * Coregion(active_dims) under a
SwitchedLikelihood, its ELBO, gradients and predictions after
``load_jax_values``; ArcCosine of orders 0, 1 and 2; Multiscale's Kuu and
Kuf and an SVGP on Multiscale inducing variables."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, covariances
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
D, P = 2, 3


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.nanmax(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _coregion(pkg, seed=0):
    k = pkg.kernels.Coregion(output_dim=P, rank=2, active_dims=[D])
    rng = np.random.RandomState(seed)
    k.W.assign(rng.randn(P, 2))
    k.kappa.assign(0.5 + rng.rand(P))
    return k


def _labels(rng, *shape):
    return rng.randint(0, P, size=shape + (1,)).astype(float)


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("second", [False, True])
def test_coregion_matches_jax(second, batch):
    rng = np.random.RandomState(1)
    lead = (2,) if batch else ()
    X = _labels(rng, *lead, 6)
    X2 = _labels(rng, 4) if second else None
    jk, pk = _coregion(gpflow_tpu), _coregion(gpflow_tpu_torch)
    with torch.no_grad():
        _close(pk.K(_t(X), None if X2 is None else _t(X2)), jk.K(X, X2))
        _close(pk.K_diag(_t(X)), jk.K_diag(X))
        _close(pk.output_covariance(), jk.output_covariance())
        _close(pk.output_variance(), jk.output_variance())


@pytest.mark.parametrize("bad", [-1.0, float(P), P + 2.5])
def test_coregion_invalid_index_gives_nan_as_jax(bad):
    """An index outside [0, output_dim) poisons its row and column (and its
    diagonal entry) with NaN, in both packages; -0.5 truncates to 0 and is
    valid in both."""
    X = np.array([[0.0], [2.0], [bad], [-0.5]])
    jk, pk = _coregion(gpflow_tpu), _coregion(gpflow_tpu_torch)
    want_K, want_d = np.asarray(jk.K(X)), np.asarray(jk.K_diag(X))
    with torch.no_grad():
        got_K, got_d = pk.K(_t(X)).numpy(), pk.K_diag(_t(X)).numpy()
    np.testing.assert_array_equal(np.isnan(got_K), np.isnan(want_K))
    np.testing.assert_array_equal(np.isnan(got_d), np.isnan(want_d))
    assert np.isnan(got_K[2]).all() and np.isnan(got_K[:, 2]).all() and np.isnan(got_d[2])
    assert np.isfinite(np.delete(np.delete(got_K, 2, 0), 2, 1)).all()
    _close(np.nan_to_num(got_K), np.nan_to_num(want_K))


def test_coregion_nan_index_gives_nan():
    """A NaN label is no index: the port gives NaN in its row and column.
    The JAX package's integer cast maps NaN to 0 on XLA's CPU, so there a
    NaN label reads output 0 (a deviation on purpose, ROADMAP.md)."""
    X = np.array([[0.0], [float("nan")], [1.0]])
    pk = _coregion(gpflow_tpu_torch)
    with torch.no_grad():
        K, d = pk.K(_t(X)).numpy(), pk.K_diag(_t(X)).numpy()
    assert np.isnan(K[1]).all() and np.isnan(K[:, 1]).all() and np.isnan(d[1])
    assert np.isfinite(K[[0, 2]][:, [0, 2]]).all() and np.isfinite(d[[0, 2]]).all()
    assert np.isfinite(np.asarray(_coregion(gpflow_tpu).K(X))).all()


def _switched_svgp(pkg, seed):
    """An SVGP on stacked data [x, output index] with SquaredExponential on
    the inputs times Coregion on the index, one Gaussian per output."""
    rng = np.random.RandomState(seed)
    n = 18
    x = rng.randn(n, D)
    idx = _labels(rng, n)
    X = np.hstack([x, idx])
    Y = np.hstack([np.sin(x[:, :1]) + 0.5 * idx + 0.1 * rng.randn(n, 1), idx])
    Z = np.hstack([rng.randn(6, D), _labels(rng, 6)])
    kernel = pkg.kernels.SquaredExponential(lengthscales=[0.9, 1.2], active_dims=list(range(D))) * _coregion(pkg, seed)
    lik = pkg.likelihoods.SwitchedLikelihood([pkg.likelihoods.Gaussian(0.1 + 0.1 * p) for p in range(P)])
    model = pkg.models.SVGP(kernel, lik, Z, num_latent_gps=1, num_data=50)
    q = rng.randn(6, 1)
    Lq = np.tril(0.1 * rng.randn(1, 6, 6), k=-1) + np.diag(0.4 + rng.rand(6))[None]
    model.q_mu.assign(q)
    model.q_sqrt.assign(Lq)
    return model, (X, Y)


def test_coregion_switched_svgp_matches_jax_after_load():
    jm, data = _switched_svgp(gpflow_tpu, 2)
    pm, _ = _switched_svgp(gpflow_tpu_torch, 3)  # other values, replaced by the load
    values = read_values(jm)
    assert sorted(parameter_dict(pm)) == sorted(values)
    assert ".kernel.kernels[1].W" in values and ".kernel.kernels[1].kappa" in values
    load_jax_values(pm, values)
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    jv, jg = jax.value_and_grad(functionalize(lambda: jm.training_loss(data), [jparams[p] for p in paths]))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    pdata = tuple(_t(a) for a in data)
    pv = pm.training_loss(pdata)
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    _close(pv.detach(), jv)
    for g, w in zip(pg, jg):
        _close(g, w)
    Xnew = data[0][:7]
    with torch.no_grad():
        for full_cov in (False, True):
            for got, want in zip(pm.predict_f(_t(Xnew), full_cov=full_cov), jm.predict_f(Xnew, full_cov=full_cov)):
                _close(got, want)
        for got, want in zip(pm.predict_y(_t(Xnew)), jm.predict_y(Xnew)):
            _close(got, want)
        _close(pm.predict_log_density(pdata), jm.predict_log_density(data))


@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_arccosine_matches_jax(order, ard):
    """At a coincident pair cos(theta) rounds near 1, where arccos's slope
    turns its float64 rounding into ~sqrt(2 eps64) of theta. Order 0's J is
    pi - theta, so K(X)'s diagonal carries that in both packages: there
    the limit is 4 * variance / pi * sqrt(2 eps64). Orders 1 and 2 have a
    flat J at theta = 0."""
    rng = np.random.RandomState(4)
    X, X2, XB = rng.randn(6, D), rng.randn(4, D), rng.randn(2, 3, D)
    wv = [0.7, 1.6] if ard else 1.3
    variance = 1.2
    coincident = 4 * variance / np.pi * np.sqrt(2 * np.finfo(np.float64).eps) / variance if order == 0 else RTOL

    def make(pkg):
        return pkg.kernels.ArcCosine(order, variance=variance, weight_variances=wv, bias_variance=0.4)

    jk, pk = make(gpflow_tpu), make(gpflow_tpu_torch)
    with torch.no_grad():
        _close(pk(_t(X)), jk(X), coincident)
        _close(pk(_t(X), _t(X2)), jk(X, X2))
        _close(pk(_t(XB), _t(X2)), jk(XB, X2))
        _close(pk(_t(XB)), jk(XB), coincident)
        _close(pk(_t(X), full_cov=False), jk(X, full_cov=False))
    assert pk.ard == jk.ard
    with pytest.raises(ValueError, match="not implemented"):
        gpflow_tpu_torch.kernels.ArcCosine(3)


def _multiscale(pkg, seed=5):
    rng = np.random.RandomState(seed)
    return pkg.inducing_variables.Multiscale(rng.randn(5, D), 0.2 + rng.rand(5, D))


@pytest.mark.parametrize("ard", [False, True])
def test_multiscale_kuu_kuf_match_jax(ard):
    ls = [0.8, 1.3] if ard else 0.9
    jk = gpflow_tpu.kernels.SquaredExponential(variance=1.4, lengthscales=ls)
    pk = gpflow_tpu_torch.kernels.SquaredExponential(variance=1.4, lengthscales=ls)
    Xnew = np.random.RandomState(6).randn(7, D)
    jiv, piv = _multiscale(gpflow_tpu), _multiscale(gpflow_tpu_torch)
    assert piv.shape == jiv.shape and len(piv) == 5
    with torch.no_grad():
        _close(covariances.Kuu(piv, pk, jitter=1e-4), gpflow_tpu.covariances.Kuu(jiv, jk, jitter=1e-4))
        _close(covariances.Kuf(piv, pk, _t(Xnew)), gpflow_tpu.covariances.Kuf(jiv, jk, Xnew))


def test_svgp_on_multiscale_matches_jax():
    """The single-output posterior serves any inducing variables, as in the
    JAX package (an SVGP on Multiscale raised before the port registered it
    on (Kernel, InducingVariables))."""
    rng = np.random.RandomState(7)
    X, Xnew = rng.randn(12, D), rng.randn(5, D)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(12, 1)

    def make(pkg):
        return pkg.models.SVGP(pkg.kernels.SquaredExponential(lengthscales=[0.8, 1.1]), pkg.likelihoods.Gaussian(0.2),
                               _multiscale(pkg), num_data=12)

    jm, pm = make(gpflow_tpu), make(gpflow_tpu_torch)
    jm.q_mu.assign(rng.randn(5, 1))
    load_jax_values(pm, read_values(jm))
    with torch.no_grad():
        _close(pm.elbo((_t(X), _t(Y))), jm.elbo((X, Y)))
        post = pm.posterior()
        assert isinstance(post, gpflow_tpu_torch.posteriors.IndependentPosteriorSingleOutput)
        want = jm.predict_f(Xnew)
        for got, w in zip(post.predict_f(_t(Xnew)), want):
            _close(got, w)
        for got, w in zip(pm.predict_f(_t(Xnew)), want):
            _close(got, w)


@pytest.mark.parametrize("dims", [[0, 1, 2], [1], [0, 2, 4], [3, 1], [4, 0, 2], [-1, 0], []], ids=str)
def test_kernel_slice_matches_list_indexing(dims):
    """A kernel's active dims are taken without a list index (which would
    copy the list to the card and synchronise the host): the columns are
    the same as X[..., dims]."""
    X = np.random.RandomState(8).randn(2, 3, 5)
    k = gpflow_tpu_torch.kernels.SquaredExponential(active_dims=dims)
    got, got2 = k.slice(_t(X), _t(X[0]))
    want = X[..., np.asarray(dims, dtype=int)]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got2.numpy(), want[0])

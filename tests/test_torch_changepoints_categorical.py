"""``kernels.ChangePoints`` and ``kernels.Categorical`` of gpflow_tpu_torch
against gpflow_tpu on the CPU, in float64 on the same seeded numpy inputs:
K, K(X, X2) and K_diag with batch dimensions and their gradients in every
trainable parameter (one and two locations, per-location steepness, nested
change-points; Categorical's latent values Z from its ``Z_deltas``), and a
GPR with each kernel after ``load_jax_values``: the objective, its gradient
and the predictions. Everything agrees to RTOL = 1e-10 relative to the
largest entry. Also: the JAX package's own cases
(``tests/gpflow_tpu/kernels/test_kernels.py``, ``test_kernel_contracts.py``,
``test_broadcasting_full.py``), Categorical's draw of its ``Z_deltas`` from
numpy's global state, its NaN rows (a NaN label's is a recorded deviation),
and the shape contracts. The JAX side runs under ``jax.jit``."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels
from gpflow_tpu_torch.kernels.categorical import latent_from_labels
from gpflow_tpu_torch.models import GPR
from gpflow_tpu_torch.utilities import ShapeError, load_jax_values, parameter_dict, set_enable_check_shapes
from gpflow_tpu_torch.utilities import read_values as port_read_values

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10  # float64 parity of every output, relative to its largest entry
rng = np.random.RandomState(31)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _close_grads(got, want):
    """Each gradient within RTOL of the largest entry of all of them."""
    assert sorted(got) == sorted(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(_np(got[path]), np.asarray(w), rtol=0.0, atol=RTOL * scale, err_msg=path)


def _value_and_grads(jm, pm, jfn, pfn):
    """``jfn()`` and ``pfn()`` with their gradients in every trainable
    parameter's unconstrained value, keyed by path."""
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    jv, jg = jax.jit(jax.value_and_grad(functionalize(jfn, [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pfn()
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    return (jv, dict(zip(paths, jg))), (pv.detach(), dict(zip(paths, pg)))


def _calls(k, X, X2):
    return k(X), k(X, X2), k(X, full_cov=False)


def _check_kernel(jk, pk, X, X2):
    """The three calls and the gradient of a weighted sum of them."""
    t, t2 = torch.from_numpy(X), torch.from_numpy(X2)
    want = jax.jit(lambda: _calls(jk, X, X2))()
    got = _calls(pk, t, t2)
    for g, w in zip(got, want):
        _close(g, w)
    r = np.random.RandomState(32)
    G = [r.randn(*np.shape(w)) for w in want]
    (jv, jg), (pv, pg) = _value_and_grads(
        jk, pk, lambda: sum((k * g).sum() for k, g in zip(_calls(jk, X, X2), G)),
        lambda: sum((k * torch.from_numpy(g)).sum() for k, g in zip(_calls(pk, t, t2), G)))
    _close(pv, jv)
    _close_grads(pg, jg)
    return pg


# --- ChangePoints ----------------------------------------------------------------------------


def _changepoints(pkg, case):
    k = pkg.kernels
    if case == "one location":
        return k.ChangePoints([k.Matern32(lengthscales=1.0), k.Matern32(lengthscales=0.2)], locations=[4.0],
                              steepness=5.0)
    if case == "two locations, steepness each":  # unsorted, so the sort shows
        return k.ChangePoints([k.SquaredExponential(lengthscales=0.7), k.Matern52(variance=2.0), k.Constant(0.4)],
                              locations=[6.0, 3.0], steepness=[1.5, 4.0])
    if case == "nested":
        inner = k.ChangePoints([k.Matern12(), k.Linear(variance=0.3)], locations=[7.0], steepness=2.0)
        return k.ChangePoints([k.RationalQuadratic(alpha=0.8), inner], locations=[2.5], steepness=3.0)
    raise KeyError(case)


CP_CASES = ["one location", "two locations, steepness each", "nested"]


@pytest.mark.parametrize("case", CP_CASES)
def test_changepoints_matches_jax_with_gradients(case):
    X, X2 = rng.rand(2, 5, 1) * 10, rng.rand(4, 1) * 10
    grads = _check_kernel(_changepoints(gpflow_tpu, case), _changepoints(gpflow_tpu_torch, case), X, X2)
    assert ".locations" in grads and ".steepness" in grads
    assert float(grads[".locations"].abs().max()) > 0


def test_nested_changepoints_are_not_flattened():
    k = _changepoints(gpflow_tpu_torch, "nested")
    assert len(k.kernels) == 2 and isinstance(k.kernels[1], kernels.ChangePoints)
    assert sorted(read_values(_changepoints(gpflow_tpu, "nested"))) == sorted(parameter_dict(k))
    assert ".kernels[1].kernels[1].variance" in parameter_dict(k)


def test_changepoints_regimes():
    # tests/gpflow_tpu/kernels/test_kernels.py:195-206
    k = kernels.ChangePoints([kernels.Constant(variance=1.0), kernels.Constant(variance=4.0)], locations=[0.0],
                             steepness=50.0)
    X = torch.tensor([[-10.0], [10.0]], dtype=torch.float64)
    K = k(X).detach().numpy()
    np.testing.assert_allclose(K[0, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(K[1, 1], 4.0, atol=1e-4)
    np.testing.assert_allclose(k(X, full_cov=False).detach().numpy(), np.diag(K), rtol=1e-8)


def test_changepoints_rejects_multidim_input():
    # tests/gpflow_tpu/kernels/test_kernels.py:251-260
    k = kernels.ChangePoints([kernels.Matern32(), kernels.Constant()], locations=[0.0], steepness=2.0)
    X2d = torch.from_numpy(np.random.RandomState(0).randn(5, 2))
    with pytest.raises(ValueError, match="1-dimensional"):
        k(X2d)
    with pytest.raises(ValueError, match="1-dimensional"):
        k(X2d, full_cov=False)
    with pytest.raises(ValueError, match="1-dimensional"):
        k(X2d[:, :1], X2d)
    assert k(X2d[:, :1]).shape == (5, 5)


def test_changepoints_init_failures():
    # tests/gpflow_tpu/kernels/test_kernel_contracts.py:197-202
    ks = [kernels.Matern12(), kernels.Linear(), kernels.Matern32()]
    with pytest.raises(ValueError, match="one more than"):
        kernels.ChangePoints(ks, [1.0], steepness=1.0)
    with pytest.raises(ValueError, match="steepness"):
        kernels.ChangePoints(ks, [1.0, 2.0], steepness=[1.0])
    k = kernels.ChangePoints(ks, [1.0, 2.0], steepness=[1.0, 3.0])
    assert k.steepness.shape == (2,) and float(k.steepness.unconstrained.detach()[0]) != 1.0  # positive(): softplus


def test_changepoints_broadcast_over_batches():
    # tests/gpflow_tpu/kernels/test_broadcasting_full.py:35-95
    k = kernels.ChangePoints([kernels.Matern32(), kernels.Matern32()], [0.5])
    X, X2 = torch.from_numpy(rng.rand(3, 2, 4, 1)), torch.from_numpy(rng.rand(2, 5, 1))
    K = k(X, X2).detach().numpy()
    assert K.shape == (3, 2, 4, 2, 5)
    for a in range(3):
        for b in range(2):
            for c in range(2):
                np.testing.assert_allclose(K[a, b, :, c], k(X[a, b], X2[c]).detach().numpy(), rtol=1e-12)


# --- Categorical ------------------------------------------------------------------------------

LABELS = 4


def _categorical(pkg, seed=33):
    np.random.seed(seed)  # both packages draw the Z_deltas from numpy's global state
    k = pkg.kernels
    return k.Categorical(k.SquaredExponential(variance=1.2, lengthscales=0.8, active_dims=[0, 1]),
                         k.SquaredExponential(lengthscales=0.5, active_dims=[2]), num_labels=LABELS)


def _labelled(*shape, seed=34):
    r = np.random.RandomState(seed)
    return np.concatenate([r.rand(*shape, 2), r.randint(0, LABELS, shape + (1,)).astype(float)], axis=-1)


def test_categorical_draws_its_z_deltas_as_jax_does():
    jk, pk = _categorical(gpflow_tpu), _categorical(gpflow_tpu_torch)
    deltas = pk._Z_deltas.numpy()
    assert deltas.shape == (LABELS - 1, 1)
    _close(deltas, read_values(jk)["._Z_deltas"], 0.0)
    _close(pk.Z, jk.Z)
    np.testing.assert_array_equal(pk.Z.detach().numpy()[:, 0], np.concatenate([[0.0], np.cumsum(deltas)]))
    assert not np.array_equal(deltas, _categorical(gpflow_tpu_torch, seed=35)._Z_deltas.numpy())


def test_categorical_matches_jax_with_gradients():
    jk, pk = _categorical(gpflow_tpu), _categorical(gpflow_tpu_torch)
    assert sorted(read_values(jk)) == sorted(parameter_dict(pk))
    grads = _check_kernel(jk, pk, _labelled(2, 5), _labelled(3, seed=36))
    assert sorted(grads) == ["._Z_deltas", ".wrapped_kernel.kernels[0].lengthscales",
                             ".wrapped_kernel.kernels[0].variance"]  # the categorical kernel is frozen


def test_categorical_terms_see_every_column_as_in_jax():
    """Categorical's K is its product's K, which cuts no term to its active
    dims: each SquaredExponential here sees all three columns, in both
    packages."""
    jk, pk = _categorical(gpflow_tpu), _categorical(gpflow_tpu_torch)
    X = _labelled(6)
    Xl = np.concatenate([X[:, :2], pk.Z.detach().numpy()[X[:, 2].astype(int)]], axis=1)
    t = torch.from_numpy(Xl)
    whole = [kernels.SquaredExponential(variance=1.2, lengthscales=0.8), kernels.SquaredExponential(lengthscales=0.5)]
    _close(pk(torch.from_numpy(X)), whole[0](t) * whole[1](t))
    _close(np.asarray(jk(X)), whole[0](t) * whole[1](t))


def test_out_of_range_labels_give_nan_rows_in_both_packages():
    X = _labelled(5)
    X[1, 2], X[3, 2] = LABELS, -1.0
    X[2, 2], X[4, 2] = LABELS - 0.5, -0.5  # the cast truncates: labels 3 and 0, in range
    jk, pk = _categorical(gpflow_tpu), _categorical(gpflow_tpu_torch)
    want, got = np.asarray(jk(X)), pk(torch.from_numpy(X)).detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[[1, 3]]).all() and np.isnan(got[:, [1, 3]]).all() and not np.isnan(got[0, [0, 2, 4]]).any()
    ok = [0, 2, 4]
    _close(got[np.ix_(ok, ok)], want[np.ix_(ok, ok)])
    # a stationary K_diag reads no input: the diagonal stays finite in both
    _close(pk(torch.from_numpy(X), full_cov=False), np.asarray(jk(X, full_cov=False)))


def test_nan_label_gives_a_nan_row():
    """A recorded deviation: the JAX package's integer cast maps a NaN label
    to 0 on XLA's CPU, a valid row; the port gives NaN, as Coregion does."""
    X = _labelled(4)
    X[2, 2] = np.nan
    jk, pk = _categorical(gpflow_tpu), _categorical(gpflow_tpu_torch)
    got = pk(torch.from_numpy(X)).detach().numpy()
    assert np.isnan(got[2]).all() and np.isnan(got[:, 2]).all() and not np.isnan(got[np.ix_([0, 1, 3], [0, 1, 3])]).any()
    assert not np.isnan(np.asarray(jk(X))[2]).any()
    Z = torch.arange(3.0, dtype=torch.float64)[:, None]
    out = latent_from_labels(Z, torch.tensor([np.nan, np.inf, 1.0, 2.9], dtype=torch.float64))
    assert np.isnan(out[:2].numpy()).all() and out[2:, 0].tolist() == [1.0, 2.0]


# --- GPR with each kernel ---------------------------------------------------------------------


def _gpr_data(case):
    r = np.random.RandomState(37)
    if case == "ChangePoints":
        X = np.sort(r.rand(30, 1) * 10, axis=0)
        Y = np.where(X < 5, np.sin(X), np.sin(4 * X)) + 0.1 * r.randn(30, 1)
        return X, Y, r.rand(7, 1) * 10
    X = _labelled(30, seed=38)
    Y = np.sin(3 * X[:, :1]) + 0.3 * X[:, 2:] + 0.1 * r.randn(30, 1)
    return X, Y, _labelled(7, seed=39)


def _gpr_models(case):
    X, Y, Xnew = _gpr_data(case)
    models = []
    for pkg in (gpflow_tpu, gpflow_tpu_torch):
        k = _changepoints(pkg, "one location") if case == "ChangePoints" else _categorical(pkg)
        models.append(pkg.models.GPR((X, Y), k, noise_variance=0.1))
    jm, pm = models
    load_jax_values(pm, read_values(jm))
    return jm, pm, Xnew


@pytest.mark.parametrize("case", ["ChangePoints", "Categorical"])
def test_gpr_objective_gradient_and_predictions_match_jax(case):
    jm, pm, Xnew = _gpr_models(case)
    assert isinstance(pm, GPR)
    (jv, jg), (pv, pg) = _value_and_grads(jm, pm, lambda: jm.training_loss(), lambda: pm.training_loss())
    _close(pv, jv)
    _close_grads(pg, jg)
    want = jax.jit(lambda: (jm.predict_f(Xnew), jm.predict_f(Xnew, full_cov=True), jm.predict_y(Xnew)))()
    with torch.no_grad():
        t = torch.from_numpy(Xnew)
        got = (pm.predict_f(t), pm.predict_f(t, full_cov=True), pm.predict_y(t))
        cached = pm.posterior().predict_f(t)
    for g, w in zip(got + (cached,), want + (want[0],)):
        _close(g[0], w[0])
        _close(g[1], w[1])


def _k1_route_on_the_cpu(monkeypatch):
    """float32 CPU tensors take the K1 route (the autograd Function and its
    backward), the forward forming d2 as K1 does: a sum of squared
    differences, not the plain version's norm expansion."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    plain = pd.stationary_forward_plain

    def direct(family, Xs, Zs, variance, alpha=None):
        if Xs.dtype != torch.float32:
            return plain(family, Xs, Zs, variance, alpha)
        return torch.as_tensor(variance).to(torch.float32) * pd._tail_value(family, pd._direct_d2(Xs, Zs), alpha)

    monkeypatch.setattr(kernels.stationaries, "_routes_to_kernel", lambda X: X.dtype == torch.float32)
    monkeypatch.setattr(pd, "stationary_forward_plain", direct)


@pytest.mark.parametrize("case", ["ChangePoints", "Categorical"])
def test_float32_gradients_hold_far_from_the_origin(case, monkeypatch):
    """F2 (ROADMAP): on the K1 route, a float32 GPR's gradient in every
    parameter lies within cond(K + noise I) * eps32 of float64 (phase 9's
    limit), where the inputs lie many lengthscales from the origin: a 1-D
    series over 50 of the rough kernel's lengthscales, latent label values
    up to ~45. The backward formed 2 (rowsum(W) x - W z) in float32, which
    cancelled there (2e-4 and 1.4e-3 of the float64 gradient at N = 512)."""
    _k1_route_on_the_cpu(monkeypatch)
    r = np.random.RandomState(40)
    n = 512
    if case == "ChangePoints":
        X = np.sort(r.rand(n, 1) * 10, axis=0)
        Y = np.where(X < 5, np.sin(X), np.sin(4 * X)) + 0.1 * r.randn(n, 1)
    else:
        labels = r.randint(0, 10, (n, 1))
        X = np.concatenate([r.rand(n, 3), labels], axis=1)
        Y = np.sin(3 * X[:, :1]) + r.randn(10)[labels] + 0.1 * r.randn(n, 1)
    models = {}
    for dtype in (torch.float32, torch.float64):
        with config.as_context(config.Config(float=dtype, device="cpu")):
            if case == "ChangePoints":
                k = kernels.ChangePoints([kernels.Matern32(lengthscales=1.0), kernels.Matern32(lengthscales=0.2)],
                                         locations=[4.0], steepness=5.0)
            else:
                np.random.seed(41)
                k = kernels.Categorical(kernels.SquaredExponential(active_dims=[0, 1, 2]),
                                        kernels.SquaredExponential(active_dims=[3]), num_labels=10)
            data = tuple(torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (X, Y))
            models[dtype] = GPR(data, k, noise_variance=0.1).to(dtype=dtype)
    load_jax_values(models[torch.float64], port_read_values(models[torch.float32]))
    with torch.no_grad():
        m64 = models[torch.float64]
        eig = torch.linalg.eigvalsh(m64.kernel(m64.data[0]))
    tol = (float(eig[-1]) + 0.1) / (max(float(eig[0]), 0.0) + 0.1) * float(np.finfo(np.float32).eps)
    grads = {}
    for dtype, m in models.items():
        loss = m.training_loss()
        grads[dtype] = torch.autograd.grad(loss, [p.unconstrained for p in m.trainable_variables])
    paths = [p for p, v in parameter_dict(models[torch.float32]).items() if v.trainable]
    for path, got, want in zip(paths, *grads.values()):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= tol, (path, err, tol)


# --- the contracts ------------------------------------------------------------------------------


@pytest.fixture
def checks_on():
    set_enable_check_shapes(True)
    try:
        yield
    finally:
        set_enable_check_shapes(False)


def _wrong_shape_calls():
    cp = _changepoints(gpflow_tpu_torch, "one location")
    cat = _categorical(gpflow_tpu_torch)
    return {
        "ChangePoints.__init__ locations": lambda: kernels.ChangePoints(
            [kernels.Matern32(), kernels.Matern32()], locations=np.zeros((1, 1))),
        "ChangePoints.K": lambda: cp.K(torch.zeros(4, 1), torch.zeros(3, 2)),
        "ChangePoints.K_diag": lambda: cp.K_diag(torch.zeros(4)),
        "Categorical.K": lambda: cat.K(torch.zeros(4, 3), torch.zeros(2, 2)),
        "Categorical.K_diag": lambda: cat.K_diag(torch.zeros(3)),
    }


@pytest.mark.parametrize("name", sorted(_wrong_shape_calls()))
def test_each_contract_rejects_a_wrong_shape(name, checks_on):
    with pytest.raises(ShapeError):
        _wrong_shape_calls()[name]()


def test_the_models_run_with_checks_on_and_give_the_same_numbers():
    outputs = {}
    for enabled in (False, True):
        outputs[enabled] = []
        for case in ("ChangePoints", "Categorical"):
            _, pm, Xnew = _gpr_models(case)
            set_enable_check_shapes(enabled)
            try:
                loss = pm.training_loss()
                grads = torch.autograd.grad(loss, [p.unconstrained for p in pm.trainable_parameters])
                with torch.no_grad():
                    t = torch.from_numpy(Xnew)
                    outputs[enabled] += [loss.detach(), *grads, *pm.predict_f(t, full_cov=True), *pm.predict_y(t)]
            finally:
                set_enable_check_shapes(False)
    for a, b in zip(outputs[False], outputs[True]):
        assert torch.equal(a, b)

"""``kernels.Convolutional`` and its ``(InducingPatches, Convolutional)``
registrations ``Kuu_conv_patch`` and ``Kuf_conv_patch`` of gpflow_tpu_torch
against gpflow_tpu on the CPU, in float64 on the same seeded numpy inputs:
``get_patches`` at 1 and 3 colour channels, ``K``, ``K(X, X2)`` and
``K_diag`` with batch dimensions and their gradients, Kuu and Kuf, and a
small multiclass convolutional SVGP (6x6 images, 3x3 patches, M = 8, C = 3)
after ``load_jax_values``: its ELBO, the gradient in every trainable
parameter and its predictions. Everything agrees to RTOL = 1e-10 relative to
the largest entry. Also: the port's flattened Kuf route against the JAX
package's batched one, which calls reach K1's route, the JAX package's own
cases (``tests/gpflow_tpu/kernels/test_kernels.py``,
``test_kernel_contracts.py``, ``test_broadcasting_full.py``,
``covariances/test_covariances.py``, ``test_inducing_variables.py``) and the
shape contracts. Large JAX computations run under ``jax.jit``."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, inducing_variables, kernels
from gpflow_tpu_torch.covariances import Kuf, Kuu
from gpflow_tpu_torch.covariances.kufs import Kuf_conv_patch
from gpflow_tpu_torch.covariances.kuus import Kuu_conv_patch
from gpflow_tpu_torch.kernels import stationaries
from gpflow_tpu_torch.utilities import ShapeError, load_jax_values, parameter_dict, set_enable_check_shapes
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10  # float64 parity of every output, relative to its largest entry

IMAGE, PATCH = (5, 4), (2, 3)  # non-square, so rows and columns cannot be swapped unseen
S = PATCH[0] * PATCH[1]
rng = np.random.RandomState(7)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _base(pkg, name):
    if name == "SquaredExponential":
        return pkg.kernels.SquaredExponential(variance=1.3, lengthscales=0.4 + 0.1 * np.arange(S))
    return pkg.kernels.Matern52(variance=0.8, lengthscales=0.9)


def _conv(pkg, base, channels):
    P = (IMAGE[0] - PATCH[0] + 1) * (IMAGE[1] - PATCH[1] + 1) * channels
    weights = 0.5 + np.arange(P) / P  # not uniform, so the weights' order shows
    return pkg.kernels.Convolutional(_base(pkg, base), IMAGE, PATCH, weights=weights, colour_channels=channels)


def _images(batch, n, channels, seed):
    return np.random.RandomState(seed).rand(*batch, n, IMAGE[0] * IMAGE[1] * channels)


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("channels", [1, 3])
def test_get_patches_matches_jax(channels, batch):
    X = _images(batch, 4, channels, 1)
    jk, pk = _conv(gpflow_tpu, "SquaredExponential", channels), _conv(gpflow_tpu_torch, "SquaredExponential", channels)
    want = np.asarray(jk.get_patches(X))
    got = pk.get_patches(torch.from_numpy(X))
    assert got.shape == batch + (4, pk.num_patches, pk.patch_len) and pk.patch_len == S
    _close(got, want, 0.0)


def test_get_patches_is_channel_major():
    # image n, channel c, patch position (i, j), offset (a, b) is pixel
    # (i + a, j + b) of channel c: X[n, ((i + a) W + (j + b)) C + c]
    C, (W, H) = 3, IMAGE
    k = _conv(gpflow_tpu_torch, "SquaredExponential", C)
    X = np.arange(2 * W * H * C, dtype=float).reshape(2, W * H * C)
    patches = k.get_patches(torch.from_numpy(X)).numpy()
    ow, oh = W - PATCH[0] + 1, H - PATCH[1] + 1
    for n, c, i, j, a, b in [(0, 0, 0, 0, 0, 0), (1, 2, 3, 1, 1, 2), (0, 1, 2, 0, 0, 1)]:
        assert patches[n, c * ow * oh + i * oh + j, a * PATCH[1] + b] == X[n, ((i + a) * H + (j + b)) * C + c]


def _calls(k, X, X2):
    """K(X), K(X, X2) and K_diag(X) through the kernel's ``__call__``."""
    return k(X), k(X, X2), k(X, full_cov=False)


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("base", ["SquaredExponential", "Matern52"])
def test_kernel_matches_jax(base, channels, batch):
    X, X2 = _images(batch, 3, channels, 2), _images((), 2, channels, 3)
    jk, pk = _conv(gpflow_tpu, base, channels), _conv(gpflow_tpu_torch, base, channels)
    want = reference_jit(lambda: _calls(jk, X, X2))()
    got = _calls(pk, torch.from_numpy(X), torch.from_numpy(X2))
    assert got[1].shape == batch + (3, 2)
    for g, w in zip(got, want):
        _close(g, w)


def _jax_grads(jk, fn):
    params = {p: v for p, v in jax_parameter_dict(jk).items() if v.trainable}
    paths = sorted(params)
    value, grads = reference_jit(jax.value_and_grad(functionalize(fn, [params[p] for p in paths])))(
        tuple(params[p].unconstrained_variable for p in paths))
    return value, dict(zip(paths, grads))


def _port_grads(pk, value):
    params = {p: v for p, v in parameter_dict(pk).items() if v.trainable}
    grads = torch.autograd.grad(value, [params[p].unconstrained for p in sorted(params)])
    return value.detach(), dict(zip(sorted(params), grads))


def _close_grads(got, want):
    """Each gradient within RTOL of the largest entry of all of them: a
    slope that is a cancellation, orders below the others, keeps the
    rounding of the terms it cancels."""
    assert sorted(got) == sorted(want)
    scale = max(float(np.max(np.abs(w))) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(_np(got[path]), np.asarray(w), rtol=0.0, atol=RTOL * scale, err_msg=path)


@pytest.mark.parametrize("base", ["SquaredExponential", "Matern52"])
def test_kernel_gradients_match_jax(base):
    X, X2 = _images((2,), 3, 3, 4), _images((), 2, 3, 5)
    r = np.random.RandomState(6)
    G = [r.randn(2, 3, 3), r.randn(2, 3, 2), r.randn(2, 3)]  # cotangents of K, K(X, X2) and K_diag
    jk, pk = _conv(gpflow_tpu, base, 3), _conv(gpflow_tpu_torch, base, 3)
    want, want_g = _jax_grads(jk, lambda: sum((k * g).sum() for k, g in zip(_calls(jk, X, X2), G)))
    got, got_g = _port_grads(pk, sum((k * torch.from_numpy(g)).sum()
                                     for k, g in zip(_calls(pk, torch.from_numpy(X), torch.from_numpy(X2)), G)))
    _close(got, want)
    assert sorted(got_g) == [".base_kernel.lengthscales", ".base_kernel.variance", ".weights"]
    _close_grads(got_g, want_g)


def _patches_Z(channels, m=7, seed=8):
    return np.random.RandomState(seed).rand(m, S)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("base", ["SquaredExponential", "Matern52"])
def test_kuu_and_kuf_match_jax_with_gradients(base, channels):
    from gpflow_tpu.covariances import Kuf as JaxKuf
    from gpflow_tpu.covariances import Kuu as JaxKuu

    Z, X = _patches_Z(channels), _images((), 4, channels, 9)
    jk, pk = _conv(gpflow_tpu, base, channels), _conv(gpflow_tpu_torch, base, channels)
    jiv, piv = gpflow_tpu.inducing_variables.InducingPatches(Z), inducing_variables.InducingPatches(Z)
    G = np.random.RandomState(10).randn(7, 4)
    jparams = {**{f".kernel{p}": v for p, v in jax_parameter_dict(jk).items()}, ".Z": jiv.Z}
    paths = sorted(jparams)
    want = reference_jit(lambda u: (JaxKuu(jiv, jk, jitter=1e-6), JaxKuf(jiv, jk, X),
                                    jax.grad(functionalize(lambda: (JaxKuf(jiv, jk, X) * G).sum(),
                                                           [jparams[p] for p in paths]))(u)))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    _close(Kuu(piv, pk, jitter=1e-6), want[0])
    Kzx = Kuf(piv, pk, torch.from_numpy(X))
    assert Kzx.shape == (7, 4)
    _close(Kzx, want[1])
    pparams = {**{f".kernel{p}": v for p, v in parameter_dict(pk).items()}, ".Z": piv.Z}
    got = torch.autograd.grad((Kzx * torch.from_numpy(G)).sum(), [pparams[p].unconstrained for p in paths])
    _close_grads(dict(zip(paths, got)), dict(zip(paths, want[2])))


@pytest.mark.parametrize("base", ["SquaredExponential", "Matern52"])
def test_kuf_flattened_route_matches_the_batched_route(base):
    """The port's Kuf calls the base kernel once on [N P, S]; the JAX
    package's calls it on [N, P, S]. The two orders give one function, its
    gradients included."""
    Z, X = _patches_Z(3), torch.from_numpy(_images((), 5, 3, 11))
    k = _conv(gpflow_tpu_torch, base, 3)
    iv = inducing_variables.InducingPatches(Z)

    def batched():
        Xp = k.get_patches(X)
        return torch.sum(k.base_kernel.K(iv.Z.value, Xp) * k.weights.value, dim=2) / k.num_patches

    params = [iv.Z.unconstrained, k.weights.unconstrained, k.base_kernel.lengthscales.unconstrained,
              k.base_kernel.variance.unconstrained]
    G = torch.from_numpy(np.random.RandomState(12).randn(7, 5))
    got, want = Kuf_conv_patch(iv, k, X), batched()
    _close(got, want)
    for g, w in zip(torch.autograd.grad((got * G).sum(), params), torch.autograd.grad((want * G).sum(), params)):
        _close(g, w)


def test_kuu_and_kuf_reach_the_k1_route_and_k_diag_does_not(monkeypatch):
    """With ``_routes_to_kernel`` forced true on the CPU and
    ``stationary_kernel_matrix`` recorded: Kuu and Kuf each make one 2-D
    call (K1 on the card), K(X) one; K_diag and K(X, X2) take the batched
    plain path."""
    calls = []
    real = stationaries.stationary_kernel_matrix

    def recording(X, Z, lengthscales, variance, family, alpha=None):
        calls.append((family, tuple(X.shape), tuple(Z.shape)))
        return real(X, Z, lengthscales, variance, family, alpha=alpha)

    monkeypatch.setattr(stationaries, "_routes_to_kernel", lambda X: True)
    monkeypatch.setattr(stationaries, "stationary_kernel_matrix", recording)
    k = _conv(gpflow_tpu_torch, "Matern52", 1)
    iv = inducing_variables.InducingPatches(_patches_Z(1))
    X = torch.from_numpy(_images((), 4, 1, 13))
    P = k.num_patches
    for fn, want in [(lambda: Kuu(iv, k), [("matern52", (7, S), (7, S))]),
                     (lambda: Kuf(iv, k, X), [("matern52", (7, S), (4 * P, S))]),
                     (lambda: k(X), [("matern52", (4 * P, S), (4 * P, S))]),
                     (lambda: k(X, full_cov=False), []),
                     (lambda: k(X, X[:2]), [])]:
        calls.clear()
        fn()
        assert calls == want


# --- the JAX package's own cases --------------------------------------------------------------


def test_convolutional_small_image():
    # tests/gpflow_tpu/kernels/test_kernels.py:218-228
    k = kernels.Convolutional(kernels.SquaredExponential(), [3, 3], [2, 2])
    assert k.num_patches == 4
    X = torch.from_numpy(rng.rand(2, 9))
    K = k(X).detach().numpy()
    assert K.shape == (2, 2)
    np.testing.assert_allclose(K, K.T, atol=1e-10)
    np.testing.assert_allclose(k(X, full_cov=False).detach().numpy(), np.diag(K), rtol=1e-8)


def test_convolutional_diag_matches_full_cov_diagonal():
    # tests/gpflow_tpu/kernels/test_kernel_contracts.py:319-330
    k = kernels.Convolutional(kernels.SquaredExponential(), image_shape=[4, 4], patch_shape=[2, 2])
    X = torch.from_numpy(rng.rand(5, 16))
    np.testing.assert_allclose(np.diag(k(X).detach().numpy()), k(X, full_cov=False).detach().numpy(), atol=1e-10)


def test_convolutional_broadcasts_over_batches():
    # tests/gpflow_tpu/kernels/test_broadcasting_full.py: K(X[b..., N, D],
    # X2[b2..., N2, D]) against an explicit loop over the batches
    k = kernels.Convolutional(kernels.Matern32(), [4, 4], [2, 2])
    X, X2 = torch.from_numpy(rng.rand(3, 2, 4, 16)), torch.from_numpy(rng.rand(2, 5, 16))
    K = k(X, X2).detach().numpy()
    assert K.shape == (3, 2, 4, 2, 5)
    for a in range(3):
        for b in range(2):
            for c in range(2):
                np.testing.assert_allclose(K[a, b, :, c], k(X[a, b], X2[c]).detach().numpy(), rtol=1e-12)
    Kd = k(X, full_cov=False).detach().numpy()
    for a in range(3):
        for b in range(2):
            np.testing.assert_allclose(Kd[a, b], k(X[a, b], full_cov=False).detach().numpy(), rtol=1e-12)


def test_inducing_patches_against_the_oracle():
    # tests/gpflow_tpu/covariances/test_covariances.py:57-77 and
    # tests/gpflow_tpu/test_inducing_variables.py:77-79
    M, N = 6, 5
    k = kernels.Convolutional(kernels.SquaredExponential(), [4, 4], [2, 2])
    Zp = rng.rand(M, 4)
    iv = inducing_variables.InducingPatches(Zp)
    assert iv.num_inducing == M
    X = rng.rand(N, 16)
    kuu = Kuu(iv, k, jitter=1e-6).detach().numpy()
    assert kuu.shape == (M, M)
    np.testing.assert_allclose(kuu, kuu.T, atol=1e-10)
    assert (np.linalg.eigvalsh(kuu) > 0).all()
    kuf = Kuf(iv, k, torch.from_numpy(X)).detach().numpy()
    patches = k.get_patches(torch.from_numpy(X)).numpy()
    w = k.weights.numpy()
    expected = np.zeros((M, N))
    for m in range(M):
        for n in range(N):
            r = np.exp(-0.5 * np.sum((Zp[m][None, :] - patches[n]) ** 2, -1))
            expected[m, n] = np.sum(r * w) / k.num_patches
    np.testing.assert_allclose(kuf, expected, rtol=1e-12, atol=1e-14)


def test_default_weights_are_ones_of_the_default_float():
    k = kernels.Convolutional(kernels.SquaredExponential(), [4, 4], [2, 2], colour_channels=2)
    assert k.weights.shape == (18,) and k.weights.dtype == config.default_float()
    assert bool((k.weights.value == 1).all()) and k.weights.device == torch.device("cpu")


# --- the multiclass convolutional SVGP ------------------------------------------------------------

C, M, N_IMG, SIDE, PSIDE = 3, 8, 24, 6, 3


def _svgp_data():
    r = np.random.RandomState(20)
    X = 0.2 * r.rand(N_IMG + 6, SIDE * SIDE)
    Y = r.randint(0, C, (N_IMG + 6, 1)).astype(float)
    for n, y in enumerate(Y[:, 0].astype(int)):  # a bright block whose corner names the class
        i, j = [(0, 0), (0, 3), (3, 0)][y]
        X[n].reshape(SIDE, SIDE)[i:i + PSIDE, j:j + PSIDE] += 0.8
    return X[:N_IMG], Y[:N_IMG], X[N_IMG:]


def _svgp_models(whiten, seed=21):
    X, Y, _ = _svgp_data()
    r = np.random.RandomState(seed)
    Z = r.rand(M, PSIDE * PSIDE)
    models = []
    for pkg in (gpflow_tpu, gpflow_tpu_torch):
        k = pkg.kernels.Convolutional(pkg.kernels.SquaredExponential(lengthscales=0.7), (SIDE, SIDE), (PSIDE, PSIDE))
        models.append(pkg.models.SVGP(k, pkg.likelihoods.MultiClass(C), pkg.inducing_variables.InducingPatches(Z),
                                      num_latent_gps=C, whiten=whiten, num_data=N_IMG))
    jm, pm = models
    values = read_values(jm)
    assert sorted(values) == sorted(parameter_dict(pm))
    L = np.tril(0.05 * r.randn(C, M, M))
    L[:, np.arange(M), np.arange(M)] = 0.5 + r.rand(C, M)
    values.update({".q_mu": r.randn(M, C), ".q_sqrt": L, ".kernel.weights": 0.5 + r.rand(16),
                   ".kernel.base_kernel.variance": np.array(1.4)})
    gpflow_tpu.utilities.multiple_assign(jm, values)
    load_jax_values(pm, read_values(jm))
    return jm, pm, (X, Y)


@pytest.mark.parametrize("whiten", [True, False])
def test_conv_svgp_elbo_and_gradient_match_jax(whiten):
    jm, pm, (X, Y) = _svgp_models(whiten)
    params = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(params)
    want, want_g = reference_jit(jax.value_and_grad(
        functionalize(lambda: jm.elbo((X, Y)), [params[p] for p in paths])))(
        tuple(params[p].unconstrained_variable for p in paths))
    got, got_g = _port_grads(pm, pm.elbo((torch.from_numpy(X), torch.from_numpy(Y))))
    _close(got, want)
    assert ".kernel.weights" in paths and ".inducing_variable.Z" in paths
    _close_grads(got_g, dict(zip(paths, want_g)))


def test_conv_svgp_predictions_match_jax():
    jm, pm, _ = _svgp_models(True, seed=22)
    Xnew = _svgp_data()[2]
    want = reference_jit(lambda: (jm.predict_f(Xnew), jm.predict_f(Xnew, full_cov=True), jm.predict_y(Xnew)))()
    with torch.no_grad():
        t = torch.from_numpy(Xnew)
        got = (pm.predict_f(t), pm.predict_f(t, full_cov=True), pm.predict_y(t))
        cached = pm.posterior().predict_f(t)
    for g, w in zip(got, want):
        _close(g[0], w[0])
        _close(g[1], w[1])
    _close(cached[0], want[0][0])
    _close(cached[1], want[0][1])
    assert bool(((got[2][0] >= 0) & (got[2][0] <= 1)).all())


# --- the contracts ------------------------------------------------------------------------------


@pytest.fixture
def checks_on():
    set_enable_check_shapes(True)
    try:
        yield
    finally:
        set_enable_check_shapes(False)


class _WrongShape(kernels.Kernel):
    """A base kernel with no contract whose K has a trailing axis."""

    def K(self, X, X2=None):
        return torch.zeros(X.shape[0], X.shape[0], 1)

    def K_diag(self, X):
        return torch.zeros(X.shape[0])


def _wrong_shape_calls():
    k = kernels.Convolutional(kernels.SquaredExponential(), [4, 4], [2, 2])
    iv = inducing_variables.InducingPatches(rng.rand(5, 4))
    return {
        "Convolutional.__init__ weights": lambda: kernels.Convolutional(
            kernels.SquaredExponential(), [4, 4], [2, 2], weights=np.ones((3, 3))),
        "Convolutional.get_patches": lambda: k.get_patches(torch.zeros(16)),
        "Convolutional.K": lambda: k.K(torch.zeros(3, 16), torch.zeros(2, 9)),
        "Convolutional.K_diag": lambda: k.K_diag(torch.zeros(16)),
        "Kuu_conv_patch": lambda: Kuu_conv_patch(iv, kernels.Convolutional(_WrongShape(), [4, 4], [2, 2])),
        "Kuf_conv_patch": lambda: Kuf_conv_patch(iv, k, torch.zeros(2, 3, 16)),
    }


@pytest.mark.parametrize("name", sorted(_wrong_shape_calls()))
def test_each_contract_rejects_a_wrong_shape(name, checks_on):
    with pytest.raises(ShapeError):
        _wrong_shape_calls()[name]()


def test_the_slice_runs_with_checks_on_and_gives_the_same_numbers():
    outputs = {}
    for enabled in (False, True):
        _, pm, (X, Y) = _svgp_models(True, seed=23)
        set_enable_check_shapes(enabled)
        try:
            elbo = pm.elbo((torch.from_numpy(X), torch.from_numpy(Y)))
            grads = torch.autograd.grad(elbo, [p.unconstrained for p in pm.trainable_parameters])
            with torch.no_grad():
                t = torch.from_numpy(_svgp_data()[2])
                outputs[enabled] = [elbo.detach(), *grads, *pm.predict_y(t), *pm.posterior().predict_f(t),
                                    *pm.predict_f(t, full_cov=True)]
        finally:
            set_enable_check_shapes(False)
    for a, b in zip(outputs[False], outputs[True]):
        assert torch.equal(a, b)

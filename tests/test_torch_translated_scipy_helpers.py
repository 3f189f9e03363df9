"""The JAX package's ``tests/gpflow_tpu/test_scipy_helpers.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Scipy pack/unpack/assign static helpers (reference ``optimizers/scipy.py:292-319``).
"""
import numpy as np
import pytest

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch.optimizers import Scipy
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401


def test_pack_unpack_assign_roundtrip():
    k = gpf.kernels.SquaredExponential(lengthscales=[1.0, 2.0, 3.0])
    params = list(k.trainable_parameters)

    vec = Scipy.pack_tensors(params)
    assert vec.ndim == 1 and vec.size == sum(
        max(int(np.prod(np.shape(p.unconstrained_variable))), 1) for p in params
    )

    parts = Scipy.unpack_tensors(params, vec)
    for p, a in zip(params, parts):
        np.testing.assert_allclose(a, np.asarray(p.unconstrained_variable), rtol=1e-6)

    new_vec = np.arange(vec.size, dtype=np.float64)
    Scipy.assign_tensors(params, Scipy.unpack_tensors(params, new_vec))
    np.testing.assert_allclose(Scipy.pack_tensors(params), new_vec, rtol=1e-6)


def test_pack_plain_arrays_and_empty():
    vec = Scipy.pack_tensors([np.ones((2, 2)), np.zeros(3)])
    assert vec.shape == (7,)
    assert Scipy.pack_tensors([]).shape == (0,)


def test_assign_length_mismatch_raises():
    k = gpf.kernels.SquaredExponential()
    with pytest.raises(ValueError, match="same length"):
        Scipy.assign_tensors(list(k.trainable_parameters), [np.zeros(1)] * 5)


def test_pack_layout_matches_minimize_vector():
    """pack_tensors must use the same layout as minimize's flat vector,
    including tril-packing of TriangularMask (full-cov q_sqrt) parameters."""
    import gpflow_tpu_torch as gpf

    rng = np.random.RandomState(0)
    X = rng.randn(8, 1)
    Y = rng.randn(8, 1)
    m = gpf.models.VGP(
        (X, Y), kernel=gpf.kernels.SquaredExponential(),
        likelihood=gpf.likelihoods.Gaussian(0.1),
    )
    params = list(m.trainable_variables)
    opt = Scipy()
    vec = opt.initial_parameters(params)
    packed = Scipy.pack_tensors(params)
    np.testing.assert_allclose(packed, vec, rtol=1e-10)

    parts = Scipy.unpack_tensors(params, vec)
    for p, a in zip(params, parts):
        np.testing.assert_allclose(
            a, np.asarray(p.unconstrained_variable) * (np.tril(np.ones(a.shape[-2:])) if a.ndim >= 2 and a.shape[-1] == a.shape[-2] and "q_sqrt" in (p.name or "") else 1.0),
            atol=1e-10,
        )
    Scipy.assign_tensors(params, parts)
    np.testing.assert_allclose(Scipy.pack_tensors(params), vec, rtol=1e-10)


def test_codec_packed_full_layout_shuffle_roundtrip():
    """The host-side packed<->full layout shuffle (scipy sees packed tril
    parameters; the device function sees plain row-major flattenings) is a
    lossless inverse pair, and unpack leaves zeros in strict upper
    triangles."""
    from gpflow_tpu_torch.optimizers.scipy import _ParameterCodec

    rng = np.random.RandomState(3)
    codec = _ParameterCodec.from_specs(
        [(2,), (3, 4, 4), (5,), ()], [False, True, False, False]
    )
    n_packed = 2 + 3 * 10 + 5 + 1
    n_full = 2 + 3 * 16 + 5 + 1
    x = rng.randn(n_packed)
    x_full = codec.unpack(x)
    assert x_full.shape == (n_full,)
    # tril leaf has zero strict-upper entries
    tri = x_full[2 : 2 + 48].reshape(3, 4, 4)
    assert np.all(tri[:, np.triu_indices(4, 1)[0], np.triu_indices(4, 1)[1]] == 0)
    np.testing.assert_array_equal(codec.pack(x_full), x)
    # no-tril codec: both directions are the identity (same object)
    plain = _ParameterCodec.from_specs([(2,), (3,)], [False, False])
    y = rng.randn(5)
    assert plain.unpack(y) is y and plain.pack(y) is y
    # decode_jax consumes the FULL layout and reproduces the leaves
    leaves = codec.decode_torch(asarray(x_full))
    assert [tuple(l.shape) for l in leaves] == [(2,), (3, 4, 4), (5,), ()]
    np.testing.assert_allclose(np.asarray(leaves[1]), tri)
    flat = codec.encode_torch(leaves, asarray(x_full).dtype)
    np.testing.assert_allclose(np.asarray(flat), x_full)

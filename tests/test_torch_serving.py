"""Serving artifacts and bucketing of gpflow_tpu_torch against gpflow_tpu on
the CPU, in float64: every case of the JAX package's bucketing tests fed the
same numpy inputs through both packages; GPR, SGPR, SVGP and VGP built from
one seed, carried across with ``load_jax_values``, exported by both packages
(the JAX side for the CPU only) and loaded by both, on symbolic, fixed and
bucketed exports, within the JAX serving tests' atol 1e-9; the metadata,
the errors, the frozen artifact, the kernel switch, the shape contracts
during export, and a loader process without the model code."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.utilities import bucketing as jax_bucketing
from gpflow_tpu.utilities import export_serving as jax_export_serving
from gpflow_tpu.utilities import load_serving as jax_load_serving
from gpflow_tpu.utilities import multiple_assign as jax_multiple_assign
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch import models as port_models
from gpflow_tpu_torch.ops import get_pallas_enabled, set_pallas_enabled
from gpflow_tpu_torch.utilities import (
    bucket_size_for,
    bucketize,
    export_serving,
    load_jax_values,
    load_serving,
    pad_to_bucket,
    set_enable_check_shapes,
)
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-9  # tests/gpflow_tpu/utilities/test_serving.py
N, D, M = 20, 3, 6
METHODS = ("predict_f", "predict_y", "predict_mean")
BUCKETS = (4, 16)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tree(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _tree_np(out):
    return tuple(_np(o) for o in _tree(out))


def _assert_same(got, want, atol=ATOL):
    got, want = _tree_np(got), _tree_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0.0, atol=atol)


# --- bucketing: the cases of tests/gpflow_tpu/utilities/test_bucketing.py ---


def test_bucket_size_for_powers_of_two():
    sizes = (0, 1, 2, 3, 5, 8, 9, 1000)
    assert [bucket_size_for(n) for n in sizes] == [jax_bucketing.bucket_size_for(n) for n in sizes]


@pytest.mark.parametrize("n", [0, 4, 5, 64])
def test_bucket_size_for_explicit_buckets(n):
    assert bucket_size_for(n, [4, 16, 64]) == jax_bucketing.bucket_size_for(n, [4, 16, 64])


@pytest.mark.parametrize("n, buckets", [(100, [4, 16, 64]), (-1, None)])
def test_bucket_size_for_raises_as_the_jax_package(n, buckets):
    with pytest.raises(ValueError) as jax_error:
        jax_bucketing.bucket_size_for(n, buckets)
    with pytest.raises(ValueError) as error:
        bucket_size_for(n, buckets)
    assert str(error.value) == str(jax_error.value)


@pytest.mark.parametrize("rows", [5, 8, 1])
def test_pad_to_bucket(rows):
    X = np.random.RandomState(43).randn(rows, 3)
    got, n = pad_to_bucket(X)
    want, jn = jax_bucketing.pad_to_bucket(X)
    assert n == jn == rows and isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_bucketize_calls_once_per_bucket():
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x.sum(-1), x * 2

    traces = []

    def jax_fn(x):
        traces.append(x.shape[0])
        return x.sum(-1), x * 2

    wrapped, jax_wrapped = bucketize(fn), jax_bucketing.bucketize(jax_fn)
    rng = np.random.RandomState(43)
    for n in (3, 5, 7, 8, 2, 6):
        X = rng.randn(n, 2)
        s, d = wrapped(X)
        assert s.shape == (n,) and d.shape == (n, 2)
        _assert_same((s, d), jax_wrapped(X))
    assert sorted(set(seen)) == sorted(set(traces)) == [2, 4, 8]


def _gpr_pair(kernel="SquaredExponential", n=20):
    rng = np.random.RandomState(43)
    X = rng.randn(n, 2)
    Y = np.sin(X[:, :1])
    jm = gpflow_tpu.models.GPR((X, Y), kernel=getattr(gpflow_tpu.kernels, kernel)())
    pm = port_models.GPR((X, Y), kernel=getattr(kernels, kernel)())
    load_jax_values(pm, read_values(jm))
    return jm, pm


@pytest.mark.parametrize("n", [1, 3, 11])
def test_bucketize_gp_prediction(n):
    jm, pm = _gpr_pair()
    jax_post, post = jm.posterior(), pm.posterior()
    Xt = np.random.RandomState(n).randn(n, 2)
    got = bucketize(lambda x: post.predict_f(x))(Xt)
    _assert_same(got, jax_bucketing.bucketize(lambda x: jax_post.predict_f(x))(Xt))
    _assert_same(got, pm.predict_f(torch.from_numpy(Xt)))


def test_bucketize_slices_every_padded_axis():
    X = np.random.RandomState(43).randn(5, 2)

    def fn(x):
        k = x @ x.T
        return x.sum(-1), k, k.expand((2,) + tuple(k.shape))

    def jax_fn(x):
        k = x @ x.T
        return x.sum(-1), k, jnp.broadcast_to(k, (2, *k.shape))

    got = bucketize(fn)(X)
    assert [tuple(g.shape) for g in got] == [(5,), (5, 5), (2, 5, 5)]
    _assert_same(got, jax_bucketing.bucketize(jax_fn)(X), atol=1e-12)


def test_bucketize_full_cov_gp_prediction():
    jm, pm = _gpr_pair("Matern32", n=16)
    Xt = np.random.RandomState(44).randn(5, 2)
    got = bucketize(lambda x: pm.predict_f(x, full_cov=True))(Xt)
    _assert_same(got, jax_bucketing.bucketize(lambda x: jm.predict_f(x, full_cov=True))(Xt))


@pytest.mark.parametrize("unpad", ["matching", "leading"])
def test_bucketize_unpad_modes(unpad):
    X5 = np.random.RandomState(43).randn(5, 2)
    got = bucketize(lambda x: torch.ones((x.shape[0], 8)), unpad=unpad)(X5)
    want = jax_bucketing.bucketize(lambda x: jnp.ones((x.shape[0], 8)), unpad=unpad)(X5)
    assert tuple(got.shape) == want.shape == ((5, 5) if unpad == "matching" else (5, 8))


def test_bucketize_rejects_an_unknown_unpad_mode():
    with pytest.raises(ValueError, match="unpad"):
        jax_bucketing.bucketize(lambda x: x, unpad="nope")
    with pytest.raises(ValueError, match="unpad"):
        bucketize(lambda x: x, unpad="nope")


def test_bucketize_rejects_batch_reduced_outputs():
    wrapped = bucketize(lambda x: torch.mean(x))
    jax_wrapped = jax_bucketing.bucketize(lambda x: jnp.mean(x))
    assert float(wrapped(np.ones((8, 2)))) == float(jax_wrapped(np.ones((8, 2)))) == 1.0
    for fn in (wrapped, jax_wrapped):
        with pytest.raises(ValueError, match="cannot be unpadded"):
            fn(np.ones((7, 2)))
    assert tuple(bucketize(lambda x: x * 2)(np.ones((7, 2))).shape) == (7, 2)


# --- serving parity: GPR, SGPR, SVGP, VGP ---


def _data():
    rng = np.random.RandomState(37)
    X = rng.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.05 * rng.randn(N, 1)
    return X, Y


def _q_sqrt(rng, m):
    q = np.tril(0.1 * rng.randn(1, m, m), k=-1)
    q[0, np.arange(m), np.arange(m)] = 0.5 + 0.5 * rng.rand(m)
    return q


def _jax_model(name):
    X, Y = _data()
    rng = np.random.RandomState(38)
    k = gpflow_tpu.kernels
    if name == "GPR":
        return gpflow_tpu.models.GPR((X, Y), kernel=k.Matern52(lengthscales=[0.8, 1.1, 1.3]), noise_variance=0.01)
    if name == "SGPR":
        return gpflow_tpu.models.SGPR((X, Y), kernel=k.SquaredExponential(variance=1.2), inducing_variable=X[:M].copy(),
                                      noise_variance=0.02)
    if name == "SVGP":
        m = gpflow_tpu.models.SVGP(kernel=k.SquaredExponential(lengthscales=[0.9, 1.0, 1.2]),
                                   likelihood=gpflow_tpu.likelihoods.Gaussian(0.1), inducing_variable=X[:M].copy())
        jax_multiple_assign(m, {".q_mu": rng.randn(M, 1), ".q_sqrt": _q_sqrt(rng, M)})
        return m
    m = gpflow_tpu.models.VGP((X, Y), kernel=k.Matern32(), likelihood=gpflow_tpu.likelihoods.Gaussian(0.1))
    jax_multiple_assign(m, {".q_mu": rng.randn(N, 1), ".q_sqrt": _q_sqrt(rng, N)})
    return m


def _port_model(name, jm):
    X, Y = _data()
    if name == "GPR":
        pm = port_models.GPR((X, Y), kernel=kernels.Matern52(lengthscales=np.ones(D)))
    elif name == "SGPR":
        pm = port_models.SGPR((X, Y), kernel=kernels.SquaredExponential(), inducing_variable=X[:M].copy())
    elif name == "SVGP":
        pm = port_models.SVGP(kernel=kernels.SquaredExponential(lengthscales=np.ones(D)),
                              likelihood=likelihoods.Gaussian(1.0), inducing_variable=np.zeros((M, D)))
    else:
        pm = port_models.VGP((X, Y), kernel=kernels.Matern32(), likelihood=likelihoods.Gaussian(1.0))
    load_jax_values(pm, read_values(jm))
    return pm


EXPORTS = {"symbolic": {}, "fixed": {"batch_size": 7}, "bucketed": {"bucket_sizes": BUCKETS}}
MODELS = ("GPR", "SGPR", "SVGP", "VGP")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(jax served, port served, port model) for each model and export kind,
    exported once for the module."""
    out = {}
    for name in MODELS:
        jm = _jax_model(name)
        pm = _port_model(name, jm)
        for kind, kwargs in EXPORTS.items():
            jdir = str(tmp_path_factory.mktemp(f"jax_{name}_{kind}"))
            pdir = str(tmp_path_factory.mktemp(f"port_{name}_{kind}"))
            jax_export_serving(jm, jdir, input_dim=D, methods=METHODS, platforms=("cpu",), **kwargs)
            export_serving(pm, pdir, input_dim=D, methods=METHODS, **kwargs)
            out[name, kind] = (jax_load_serving(jdir), load_serving(pdir), pm, jdir, pdir)
    return out


CASES = ([("symbolic", n) for n in (1, 7, 64)] + [("fixed", 7)]
         + [("bucketed", n) for n in (3, 16, 40)])


@pytest.mark.parametrize("kind, n", CASES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", MODELS)
def test_served_outputs_match_the_jax_package(artifacts, name, kind, n, method):
    jax_served, served, pm, _, _ = artifacts[name, kind]
    Xt = np.random.RandomState(n).randn(n, D)
    got = getattr(served, method)(Xt)
    _assert_same(got, getattr(jax_served, method)(Xt))
    assert all(o.dtype == torch.float64 and o.device.type == "cpu" for o in _tree(got))


@pytest.mark.parametrize("name", MODELS)
def test_served_outputs_match_the_live_model(artifacts, name):
    _, served, pm, _, _ = artifacts[name, "symbolic"]
    Xt = torch.from_numpy(np.random.RandomState(5).randn(9, D))
    with torch.no_grad():
        _assert_same(served.predict_f(Xt), pm.predict_f(Xt))
        _assert_same(served.predict_y(Xt), pm.predict_y(Xt))


@pytest.mark.parametrize("kind", list(EXPORTS))
def test_metadata_matches_the_jax_package(artifacts, kind):
    jax_served, served, _, _, pdir = artifacts["SVGP", kind]
    assert served.metadata == jax_served.metadata
    assert sorted(os.listdir(pdir)) == sorted(f.replace(".stablehlo", ".pt2")
                                              for f in os.listdir(artifacts["SVGP", kind][3]))
    assert served.methods == list(METHODS)


def test_fixed_export_pairs_with_bucketize(artifacts):
    _, served, pm, _, _ = artifacts["GPR", "fixed"]
    Xt = np.random.RandomState(3).randn(3, D)
    got = bucketize(served.predict_f, buckets=[7])(Xt)
    with torch.no_grad():
        _assert_same(got, pm.predict_f(torch.from_numpy(Xt)))


def _svgp():
    return _port_model("SVGP", _jax_model("SVGP"))


def test_unknown_method_raises_as_the_jax_package(tmp_path):
    with pytest.raises(ValueError, match="Unknown serving method"):
        jax_export_serving(_jax_model("GPR"), str(tmp_path / "j"), input_dim=D, methods=("predict_nope",),
                           platforms=("cpu",))
    with pytest.raises(ValueError, match="Unknown serving method"):
        export_serving(_svgp(), str(tmp_path / "p"), input_dim=D, methods=("predict_nope",))


@pytest.mark.parametrize("kwargs, match", [({"batch_size": 4, "bucket_sizes": [4]}, "not both"),
                                           ({"bucket_sizes": [0, 4]}, "positive"),
                                           ({"bucket_sizes": []}, "positive")])
def test_export_validation_as_the_jax_package(tmp_path, kwargs, match):
    with pytest.raises(ValueError, match=match):
        jax_export_serving(_jax_model("SVGP"), str(tmp_path / "j"), input_dim=D, platforms=("cpu",), **kwargs)
    with pytest.raises(ValueError, match=match):
        export_serving(_svgp(), str(tmp_path / "p"), input_dim=D, **kwargs)


@pytest.mark.parametrize("platforms", [("tpu",), ("cpu", "tpu"), ("cuda",), ()])
def test_platforms_other_than_the_models_raise(tmp_path, platforms):
    with pytest.raises(ValueError, match="device type"):
        export_serving(_svgp(), str(tmp_path), input_dim=D, platforms=platforms)


def test_artifact_is_frozen(tmp_path):
    pm = _svgp()
    export_serving(pm, str(tmp_path), input_dim=D, methods=("predict_f",))
    served = load_serving(str(tmp_path))
    Xt = np.random.RandomState(6).randn(7, D)
    before = _tree_np(served.predict_f(Xt))
    pm.kernel.lengthscales.assign(0.1 * np.ones(D))
    pm.q_mu.assign(np.zeros((M, 1)))
    _assert_same(served.predict_f(Xt), before, atol=0.0)
    assert all(p.trainable for p in pm.trainable_parameters) and pm.trainable_parameters


@pytest.mark.parametrize("switch", [None, False, True])
def test_export_leaves_the_switch_as_it_was(tmp_path, switch):
    set_pallas_enabled(switch)
    try:
        export_serving(_svgp(), str(tmp_path / "ok"), input_dim=D, methods=("predict_f",))  # float64: no kernel
        assert get_pallas_enabled() is switch
        with pytest.raises(ValueError, match="Unknown serving method"):
            export_serving(_svgp(), str(tmp_path / "bad"), input_dim=D, methods=("predict_nope",))
        assert get_pallas_enabled() is switch
    finally:
        set_pallas_enabled(None)


def test_float32_export_under_the_forced_switch_raises_on_the_cpu(tmp_path):
    pm = _svgp().to(torch.float32)
    set_pallas_enabled(True)
    try:
        with pytest.raises(ValueError, match="CUDA tensors"):
            export_serving(pm, str(tmp_path), input_dim=D, dtype=torch.float32, methods=("predict_f",))
    finally:
        set_pallas_enabled(None)


def test_export_with_shape_checks_on(tmp_path):
    pm = _svgp()
    set_enable_check_shapes(True)
    try:
        export_serving(pm, str(tmp_path), input_dim=D, methods=METHODS)
    finally:
        set_enable_check_shapes(False)
    served = load_serving(str(tmp_path))
    for n in (1, 7):
        Xt = torch.from_numpy(np.random.RandomState(n).randn(n, D))
        with torch.no_grad():
            _assert_same(served.predict_f(Xt), pm.posterior().predict_f(Xt))


def test_a_cuda_artifact_does_not_load_without_a_card(tmp_path, monkeypatch):
    export_serving(_svgp(), str(tmp_path), input_dim=D, methods=("predict_f",))
    meta = json.loads((tmp_path / "serving.json").read_text())
    (tmp_path / "serving.json").write_text(json.dumps(dict(meta, platforms=["cuda"])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_serving(str(tmp_path))


def test_a_loader_process_imports_no_model_code(artifacts, tmp_path):
    _, served, _, _, pdir = artifacts["SVGP", "bucketed"]
    Xt = np.random.RandomState(8).randn(40, D)
    np.save(tmp_path / "X.npy", Xt)
    code = (
        "import sys, numpy as np, torch\n"
        "from gpflow_tpu_torch.utilities.serving import load_serving\n"
        f"served = load_serving({pdir!r})\n"
        f"mean, var = served.predict_f(np.load({str(tmp_path / 'X.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, np.stack([mean.numpy(), var.numpy()]))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gpflow_tpu')\n"
        "             or m.startswith('gpflow_tpu_torch.models'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    # the loader took 7.5-11 s in the tier-1 run: a hang fails this case in about 3x that
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=40)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    mean, var = served.predict_f(Xt)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), np.stack([mean.numpy(), var.numpy()]))

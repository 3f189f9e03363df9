"""Checkpoints, bulk assignment and the trainer's state of gpflow_tpu_torch
against gpflow_tpu on the CPU, in float64: ``multiple_assign`` case by case
with the JAX package's (atomic on a bad path and on a bad value),
``deepcopy`` and ``freeze``, the npz checkpoint (a round trip, a partial
load, a file the JAX package writes), and ``DataParallelTrainer``'s
``state_dict``/``save_state``/``load_state`` round trip, with Adam and with
natural gradients, equal to the bit."""
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.utilities import deepcopy as jax_deepcopy
from gpflow_tpu.utilities import freeze as jax_freeze
from gpflow_tpu.utilities import multiple_assign as jax_multiple_assign
from gpflow_tpu.utilities import read_values as jax_read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.models import GPR, SVGP
from gpflow_tpu_torch.parallel import DataParallelTrainer, adam
from gpflow_tpu_torch.utilities import (
    deepcopy,
    freeze,
    load_checkpoint,
    load_jax_values,
    multiple_assign,
    read_values,
    reset_cache_bijectors,
    save_checkpoint,
)
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

N, D, M = 24, 2, 5


def _data():
    rng = np.random.RandomState(11)
    X = rng.rand(N, D) * 3
    return X, np.sin(2 * X[:, :1]) + 0.1 * rng.randn(N, 1)


def _pair():
    """An SVGP in both packages with the same values."""
    X, _ = _data()
    jm = gpflow_tpu.models.SVGP(kernel=gpflow_tpu.kernels.Matern52(lengthscales=[0.7, 1.3]),
                                likelihood=gpflow_tpu.likelihoods.Gaussian(0.2), inducing_variable=X[:M].copy())
    pm = SVGP(kernel=kernels.Matern52(lengthscales=np.ones(D)), likelihood=likelihoods.Gaussian(1.0),
              inducing_variable=np.zeros((M, D)))
    load_jax_values(pm, jax_read_values(jm))
    return jm, pm


def _values(seed):
    rng = np.random.RandomState(seed)
    q_sqrt = np.tril(0.1 * rng.randn(1, M, M), k=-1)
    q_sqrt[0, np.arange(M), np.arange(M)] = 0.5 + rng.rand(M)
    return {".kernel.variance": 1.0 + rng.rand(), ".kernel.lengthscales": 0.5 + rng.rand(D),
            ".q_mu": rng.randn(M, 1), ".q_sqrt": q_sqrt}


def _assert_values_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-15, atol=0.0)


@pytest.mark.parametrize("subset", [
    (".kernel.variance",), (".kernel.lengthscales", ".q_mu"), (".kernel.variance", ".kernel.lengthscales", ".q_mu", ".q_sqrt"),
])
def test_multiple_assign_matches_the_jax_package(subset):
    jm, pm = _pair()
    values = {k: v for k, v in _values(1).items() if k in subset}
    jax_multiple_assign(jm, values)
    multiple_assign(pm, values)
    _assert_values_equal(read_values(pm), jax_read_values(jm))


@pytest.mark.parametrize("bad, error", [
    ({".kernel.nope": 1.0}, KeyError),
    ({".kernel.variance": float("nan")}, ValueError),
    ({".kernel.variance": -1.0}, ValueError),
    ({".q_mu": np.zeros((M + 1, 1))}, ValueError),
])
def test_multiple_assign_is_atomic_as_the_jax_package(bad, error):
    jm, pm = _pair()
    before_jax, before = jax_read_values(jm), read_values(pm)
    values = dict(_values(2), **bad)  # good entries first: none of them may land
    with pytest.raises(error):
        jax_multiple_assign(jm, values)
    with pytest.raises(error):
        multiple_assign(pm, values)
    _assert_values_equal(jax_read_values(jm), before_jax)
    _assert_values_equal(read_values(pm), before)


def test_deepcopy_is_independent():
    jm, pm = _pair()
    copied = deepcopy(pm)
    assert reset_cache_bijectors(pm) is pm
    _assert_values_equal(read_values(copied), read_values(pm))
    copied.kernel.variance.assign(3.0)
    jax_copied = jax_deepcopy(jm)
    jax_copied.kernel.variance.assign(3.0)
    _assert_values_equal(read_values(pm), jax_read_values(jm))
    _assert_values_equal(read_values(copied), jax_read_values(jax_copied))


def test_freeze_makes_every_parameter_constant_in_a_copy():
    jm, pm = _pair()
    frozen, jax_frozen = freeze(pm), jax_freeze(jm)
    assert len(frozen.trainable_parameters) == len(jax_frozen.trainable_parameters) == 0
    assert not any(p.requires_grad for p in frozen.parameters())
    assert len(pm.trainable_parameters) == len(jm.trainable_parameters) > 0
    _assert_values_equal(read_values(frozen), read_values(pm))
    X = torch.from_numpy(_data()[0])
    with torch.no_grad():
        for got, want in zip(frozen.predict_f(X), pm.predict_f(X)):
            assert torch.equal(got, want)


def test_checkpoint_round_trip(tmp_path):
    _, pm = _pair()
    multiple_assign(pm, _values(3))
    save_checkpoint(str(tmp_path / "ckpt"), pm)
    _, fresh = _pair()
    loaded = load_checkpoint(str(tmp_path / "ckpt"), fresh)
    _assert_values_equal(loaded, read_values(pm))
    _assert_values_equal(read_values(fresh), read_values(pm))
    X = torch.from_numpy(_data()[0])
    with torch.no_grad():
        for got, want in zip(fresh.predict_y(X), pm.predict_y(X)):
            assert torch.equal(got, want)


def test_partial_checkpoint_load_restores_the_paths_the_module_has(tmp_path):
    _, pm = _pair()
    before = read_values(pm)
    np.savez(tmp_path / "partial.npz", **{".kernel.variance": np.asarray(2.5), ".elsewhere.variance": np.asarray(7.0)})
    loaded = load_checkpoint(str(tmp_path / "partial.npz"), pm)
    assert sorted(loaded) == [".elsewhere.variance", ".kernel.variance"]
    _assert_values_equal(read_values(pm), dict(before, **{".kernel.variance": np.asarray(2.5)}))


def test_a_checkpoint_written_by_the_jax_package_loads_into_the_port(tmp_path):
    X, Y = _data()
    jm = gpflow_tpu.models.GPR((X, Y), kernel=gpflow_tpu.kernels.SquaredExponential(variance=1.4, lengthscales=[0.6, 0.9]),
                               noise_variance=0.05)
    np.savez(tmp_path / "jax.npz", **jax_read_values(jm))
    pm = GPR((X, Y), kernel=kernels.SquaredExponential(lengthscales=np.ones(D)))
    load_checkpoint(str(tmp_path / "jax"), pm)
    Xt = np.random.RandomState(12).rand(9, D) * 3
    with torch.no_grad():
        got = pm.predict_f(torch.from_numpy(Xt))
    for g, w in zip(got, jm.predict_f(Xt)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.0, atol=1e-12)


def test_the_ports_checkpoint_loads_into_the_jax_package(tmp_path):
    jm, pm = _pair()
    multiple_assign(pm, _values(4))
    save_checkpoint(str(tmp_path / "port"), pm)
    with np.load(tmp_path / "port.npz") as npz:
        jax_multiple_assign(jm, {k: npz[k] for k in npz.files})
    _assert_values_equal(jax_read_values(jm), read_values(pm))


# --- the trainer's state ---

BATCHES = 4
TRAINERS = {"adam": {}, "natgrad": {"natgrad_gamma": 0.1}, "natgrad fused": {"natgrad_gamma": 0.1, "natgrad_fused": True}}


def _trainer(kind):
    _, pm = _pair()
    return DataParallelTrainer(pm, adam(1e-2), **TRAINERS[kind])


def _batches():
    X, Y = _data()
    b = N // BATCHES
    return [(torch.from_numpy(X[i * b:(i + 1) * b]), torch.from_numpy(Y[i * b:(i + 1) * b])) for i in range(BATCHES)]


def _steps(trainer, batches, n=5):
    return [trainer.step(batches[i % len(batches)]) for i in range(n)]


@pytest.mark.parametrize("kind", list(TRAINERS))
def test_trainer_state_round_trip_is_exact(tmp_path, kind):
    batches = _batches()
    trainer = _trainer(kind)
    _steps(trainer, batches)
    trainer.save_state(str(tmp_path / "state"))
    losses = _steps(trainer, batches)
    fresh = _trainer(kind)
    fresh.load_state(str(tmp_path / "state"))
    fresh_losses = _steps(fresh, batches)
    assert [float(a) for a in losses] == [float(b) for b in fresh_losses]
    for got, want in zip(fresh.model.parameters(), trainer.model.parameters()):
        assert torch.equal(got, want)
    for a, b in zip(fresh.state_dict().values(), trainer.state_dict().values()):
        np.testing.assert_array_equal(a, b)


def test_a_fresh_trainers_state_is_the_optimizers_starting_state():
    trainer = _trainer("adam")
    state = trainer.state_dict()
    n_params = len(trainer._params)
    assert list(state) == [f"leaf_{i:04d}" for i in range(len(state))]
    assert len(state) == 4 * n_params  # each parameter, then its exp_avg, exp_avg_sq and step
    assert all(not np.any(v) for v in list(state.values())[n_params:])
    trainer.load_state_dict(state)  # a fresh trainer's own state loads as it is
    assert trainer.optimizer.state_dict()["state"][0]["step"] == 0


def test_a_structure_mismatch_raises():
    adam_state = _trainer("adam").state_dict()
    natgrad = _trainer("natgrad")
    with pytest.raises(ValueError, match="structure mismatch"):
        natgrad.load_state_dict(adam_state)
    state = natgrad.state_dict()
    first = sorted(state)[0]
    with pytest.raises(ValueError, match="leaf shape"):
        natgrad.load_state_dict(dict(state, **{first: np.zeros(state[first].shape + (2,))}))

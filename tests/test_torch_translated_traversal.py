"""The JAX package's ``tests/gpflow_tpu/utilities/test_traversal.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Traversal / serialization utilities (reference test strategy §4:
tests/gpflow/utilities/test_traversal.py).
"""
import copy

import numpy as np
import pytest
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch import kernels, likelihoods
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.utilities import (
    freeze,
    multiple_assign,
    parameter_dict,
    print_summary,
    read_values,
    select_dict_parameters_with_prior,
    set_trainable,
)
from .test_torch_translated_support import X64, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def _model():
    return SVGP(
        kernel=kernels.Matern32(lengthscales=[1.0, 2.0]),
        likelihood=likelihoods.Gaussian(0.2),
        inducing_variable=rng.randn(5, 2),
        num_data=10,
    )


def test_parameter_dict_paths_and_read_values_roundtrip():
    m = _model()
    pd = parameter_dict(m)
    assert ".kernel.lengthscales" in pd
    assert ".likelihood.variance" in pd
    values = read_values(m)
    # perturb then restore through multiple_assign
    m.kernel.lengthscales.assign([3.0, 4.0])
    multiple_assign(m, values)
    np.testing.assert_allclose(m.kernel.lengthscales.numpy(), [1.0, 2.0])


def test_multiple_assign_unknown_key_raises():
    m = _model()
    with pytest.raises(KeyError):
        multiple_assign(m, {".kernel.nonexistent": np.ones(2)})


def test_freeze_returns_constant_copy():
    m = _model()
    frozen = freeze(m)
    # same predictions
    X = rng.randn(4, 2)
    np.testing.assert_allclose(
        np.asarray(m.predict_f(X)[0]), np.asarray(frozen.predict_f(X)[0]), rtol=1e-12
    )
    # frozen tree exposes no trainable parameters
    assert len(list(frozen.trainable_parameters)) == 0
    # and is decoupled from the original
    m.kernel.lengthscales.assign([9.0, 9.0])
    np.testing.assert_allclose(np.asarray(frozen.kernel.lengthscales), [1.0, 2.0])


def test_deepcopy_is_independent():
    m = _model()
    m2 = copy.deepcopy(m)
    m2.likelihood.variance.assign(0.7)
    assert abs(float(m.likelihood.variance.value) - 0.2) < 1e-12


def test_select_dict_parameters_with_prior():
    m = _model()
    assert select_dict_parameters_with_prior(m) == {}
    m.kernel.variance.prior = gpflow_tpu_torch.priors.LogNormal(0.0, 1.0)
    sel = select_dict_parameters_with_prior(m)
    assert list(sel) == [".kernel.variance"]


def test_print_summary_formats(capsys):
    m = _model()
    print_summary(m, fmt="simple")
    out = capsys.readouterr().out
    assert "kernel.lengthscales" in out
    assert "Softplus" in out or "softplus" in out


def test_set_trainable_toggles():
    m = _model()
    n_before = len(list(m.trainable_parameters))
    set_trainable(m.kernel, False)
    assert len(list(m.trainable_parameters)) == n_before - 2
    set_trainable(m.kernel, True)
    assert len(list(m.trainable_parameters)) == n_before


def test_profile_writes_trace(tmp_path):
    from gpflow_tpu_torch.utilities import annotate, profile

    d = str(tmp_path / "trace")
    with profile(d):
        with annotate("work"):
            float(torch.sum(torch.ones((8, 8), **X64) @ torch.ones((8, 8), **X64)))
    import os
    files = [f for root, _, fs in os.walk(d) for f in fs]
    assert files, "profiler produced no trace files"


def test_multiple_assign_invalid_value_raises():
    """Shape-mismatched or non-finite values must be rejected and leave the
    untouched parameters unchanged (reference test_base_training.py)."""
    m = _model()
    before = {k: np.asarray(v) for k, v in gpflow_tpu_torch.utilities.read_values(m).items()}
    some_key = next(iter(before))
    bad = np.ones((7, 3))  # wrong shape for any parameter here
    with pytest.raises(ValueError):
        gpflow_tpu_torch.utilities.multiple_assign(m, {some_key: bad})
    with pytest.raises(ValueError):
        gpflow_tpu_torch.utilities.multiple_assign(m, {some_key: np.nan})
    after = gpflow_tpu_torch.utilities.read_values(m)
    for k, v in before.items():
        np.testing.assert_array_equal(np.asarray(after[k]), v)


def test_multiple_assign_is_atomic_across_keys():
    """Regression: a failing entry later in the dict must
    not leave earlier entries already mutated."""
    m = _model()
    before = {k: np.asarray(v) for k, v in gpflow_tpu_torch.utilities.read_values(m).items()}
    good_key = ".kernel.lengthscales"
    bad_key = ".kernel.variance"
    assert good_key in before and bad_key in before
    with pytest.raises(ValueError):
        gpflow_tpu_torch.utilities.multiple_assign(
            m, {good_key: np.full_like(before[good_key], 9.0), bad_key: np.nan}
        )
    after = gpflow_tpu_torch.utilities.read_values(m)
    for k, v in before.items():
        np.testing.assert_array_equal(np.asarray(after[k]), v)

"""The config of gpflow_tpu_torch against gpflow_tpu's on the CPU: every
getter and setter with the JAX package's validation and errors (the cases of
``tests/gpflow_tpu/test_config.py``, each run on both packages), the
``GPFLOW_<NAME>`` environment overrides, ``positive()`` following the
configured bijector, the environment tiers (the matmul tier, the kernel
switch ``GPFLOW_TPU_PALLAS``, the shape-check switch) in one subprocess,
and ``versions``, ``ci_utils`` and ``experimental``."""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu.ci_utils
import gpflow_tpu.experimental.utils
from gpflow_tpu import config as jax_config
import gpflow_tpu_torch
from gpflow_tpu_torch import bijectors, ci_utils, config
from gpflow_tpu_torch.experimental.utils import experimental
from gpflow_tpu_torch.ops import pallas_distance as pd
from gpflow_tpu_torch.utilities import to_default_float, to_default_int

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jax_config, "torch": config}


def _name(value):
    """A dtype as numpy names it, anything else as it is."""
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    if isinstance(value, type) and issubclass(value, np.generic):
        return np.dtype(value).name
    return value


@pytest.fixture(autouse=True)
def _restore_config():
    saved = {k: (m.config(), m.__config__._jitter_explicit) for k, m in PACKAGES.items()}
    yield
    for k, m in PACKAGES.items():
        m.set_config(saved[k][0])
        m.__config__._jitter_explicit = saved[k][1]


def _both(fn):
    """``fn(config_module)`` on both packages, as a pair of results or of
    exception types."""
    out = []
    for m in PACKAGES.values():
        try:
            out.append(fn(m))
        except Exception as e:  # the exception's type is the result compared
            out.append(type(e))
    return out


_ENV_VALUES = [
    ("int", "int16", "int16"),
    ("int", "int64", "int64"),
    ("float", "float16", "float16"),
    ("float", "float32", "float32"),
    ("positive_bijector", "exp", "exp"),
    ("positive_bijector", "softplus", "softplus"),
    ("summary_fmt", "simple", "simple"),
    ("positive_minimum", "1e-3", 1e-3),
    ("likelihood_positive_minimum", "5e-4", 5e-4),
    ("jitter", "1e-2", 1e-2),
]


@pytest.mark.parametrize("attr_name, value, expected", _ENV_VALUES)
def test_env_variables(attr_name, value, expected):
    with mock.patch.dict("os.environ", {f"GPFLOW_{attr_name.upper()}": value}):
        got = _both(lambda m: _name(getattr(m.Config(), attr_name)))
    assert got == [expected, expected]


@pytest.mark.parametrize("attr_name", list(dict.fromkeys(name for name, _, _ in _ENV_VALUES)))
def test_env_variables_garbage_rejected(attr_name):
    with mock.patch.dict("os.environ", {f"GPFLOW_{attr_name.upper()}": "garbage"}):
        assert _both(lambda m: m.Config()) == [TypeError, TypeError]


@pytest.mark.parametrize("env", [{"GPFLOW_INT": "float32"}, {"GPFLOW_FLOAT": "int32"}, {"GPFLOW_FLOAT": "bool"}])
def test_env_dtype_of_the_wrong_kind_rejected(env):
    with mock.patch.dict("os.environ", env):
        assert _both(lambda m: m.Config()) == [TypeError, TypeError]


def test_env_jitter_is_explicit_at_construction():
    with mock.patch.dict("os.environ", {"GPFLOW_JITTER": "3e-3"}):
        assert _both(lambda m: m.Config(float=np.float32).jitter) == [3e-3, 3e-3]


_SETTINGS = [
    ("int", np.int64), ("int", np.int32), ("int", np.int16),
    ("float", np.float32), ("float", np.float64), ("float", np.float16),
    ("jitter", 1e-3), ("jitter", 1e-6),
    ("likelihood_positive_minimum", 1e-3), ("likelihood_positive_minimum", 1e-6),
    ("positive_minimum", 1e-3), ("positive_minimum", 0.0),
    ("positive_bijector", "exp"), ("positive_bijector", "SoftPlus"),
    ("summary_fmt", "html"), ("summary_fmt", None), ("summary_fmt", "notebook"), ("summary_fmt", "grid"),
]


@pytest.mark.parametrize("name, value", _SETTINGS)
def test_setter_and_getter(name, value):
    def run(m):
        getattr(m, f"set_default_{name}")(value)
        return _name(getattr(m, f"default_{name}")())

    got = _both(run)
    assert got[0] == got[1]
    assert got[0] == (value.lower() if isinstance(value, str) and name == "positive_bijector" else _name(value))


_BAD_SETTINGS = [
    ("int", str), ("int", np.float64), ("int", np.bool_),
    ("float", list), ("float", np.int32),
    ("jitter", "not a float"), ("jitter", -1e-10),
    ("likelihood_positive_minimum", "not a float"), ("likelihood_positive_minimum", -1e-10),
    ("positive_minimum", "not a float"), ("positive_minimum", -1e-10),
    ("positive_bijector", "Unknown"), ("positive_bijector", 1.0),
    ("summary_fmt", "this_format_definitely_does_not_exist"),
]


@pytest.mark.parametrize("name, value", _BAD_SETTINGS)
def test_setter_errors(name, value):
    got = _both(lambda m: getattr(m, f"set_default_{name}")(value))
    assert isinstance(got[0], type) and issubclass(got[0], Exception), got
    assert got[0] is got[1]


def test_defaults():
    """The same defaults but the integer type: the port keeps int64, the
    type torch indexes with, where the JAX package keeps int32."""
    got = _both(lambda m: {k: _name(v) for k, v in dataclasses.asdict(m.Config()).items() if k != "device"})
    assert got[0] == {**got[1], "int": "int32"}
    assert got[1]["int"] == "int64" and got[1]["positive_bijector"] == "softplus"
    assert got[1]["summary_fmt"] == "fancy_grid"


@pytest.mark.parametrize("name", ["softplus", "exp"])
def test_positive_bijector_type_map_builds_parameters(name):
    cls = config.positive_bijector_type_map()[name]
    assert cls.__name__ == jax_config.positive_bijector_type_map()[name].__name__
    config.set_default_positive_bijector(name)
    assert isinstance(gpflow_tpu_torch.Parameter(0.5, transform=gpflow_tpu_torch.utilities.positive()).transform, cls)


@pytest.mark.parametrize("lower", [None, 1e-3])
@pytest.mark.parametrize("name", ["softplus", "exp"])
def test_positive_follows_the_configured_bijector(name, lower):
    """``positive()`` with no ``base`` reads ``default_positive_bijector()``,
    as the JAX package's does; so does every kernel's variance."""
    for m in PACKAGES.values():
        m.set_default_positive_bijector(name)
    pb, jb = bijectors.positive(lower), gpflow_tpu.bijectors.positive(lower)
    assert pb.name == jb.name == ("chain" if lower else name)
    y = np.array([1e-3, 0.5, 1.0, 7.0])
    x = np.array(jb.inverse(y))
    np.testing.assert_allclose(pb.inverse(torch.from_numpy(y)).numpy(), x, rtol=1e-13)
    np.testing.assert_allclose(pb.forward(torch.from_numpy(x)).numpy(), np.asarray(jb.forward(x)), rtol=1e-14)
    jk = gpflow_tpu.kernels.SquaredExponential(variance=2.0)
    pk = gpflow_tpu_torch.kernels.SquaredExponential(variance=2.0)
    assert pk.variance.transform.name == jk.variance.transform.name
    np.testing.assert_allclose(pk.variance.unconstrained.detach().numpy(),
                               np.asarray(jk.variance.unconstrained_variable), rtol=1e-14)


@pytest.mark.parametrize(
    "name, converter, jax_converter, dtype, value",
    [
        ("int", to_default_int, gpflow_tpu.utilities.to_default_int, np.int32, 3),
        ("int", to_default_int, gpflow_tpu.utilities.to_default_int, np.int64, [3, 1, 4, 1, 5, 9]),
        ("float", to_default_float, gpflow_tpu.utilities.to_default_float, np.float32, 3.14159),
        ("float", to_default_float, gpflow_tpu.utilities.to_default_float, np.float64, [3.14159] * 3),
    ],
)
def test_to_default_dtype(name, converter, jax_converter, dtype, value):
    for m in PACKAGES.values():
        getattr(m, f"set_default_{name}")(dtype)
    got, want = converter(value), np.asarray(jax_converter(value))
    assert _name(got.dtype) == want.dtype.name == np.dtype(dtype).name
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("package", list(PACKAGES))
def test_as_context_restores_on_exit_and_exception(package):
    m = PACKAGES[package]
    original = m.config()
    with m.as_context(m.Config(jitter=0.123)):
        assert m.default_jitter() == 0.123
    assert m.config() == original
    with pytest.raises(RuntimeError):
        with m.as_context(m.Config(jitter=0.456)):
            raise RuntimeError("boom")
    assert m.config() == original


@pytest.mark.parametrize("package", list(PACKAGES))
def test_jitter_rules(package):
    """The jitter follows the float type (1e-6 for float64, 1e-4 otherwise)
    until it is set explicitly, by ``set_default_jitter`` or by a config
    that ``set_config`` put in place; ``as_context`` restores whether it
    was explicit."""
    m = PACKAGES[package]
    for dtype, jitter in ((np.float64, 1e-6), (np.float32, 1e-4), (np.float64, 1e-6)):
        m.set_default_float(dtype)
        assert m.default_jitter() == jitter
    assert m.Config(float=np.float32).jitter == 1e-4 and m.Config(float=np.float32, jitter=7e-5).jitter == 7e-5
    with m.as_context():
        m.set_default_jitter(1e-3)
        m.set_default_float(np.float32)
        assert m.default_jitter() == 1e-3
    m.set_default_float(np.float32)
    assert m.default_jitter() == 1e-4
    m.set_default_float(np.float64)
    m.set_config(dataclasses.replace(m.config(), jitter=1e-8))
    m.set_default_float(np.float32)
    assert m.default_jitter() == 1e-8


@pytest.mark.parametrize("value, tf32", [(None, False), ("0", False), ("", False), ("false", False),
                                         ("False", False), ("high", True), ("1", True)])
def test_matmul_tier(value, tf32):
    """``GPFLOW_TPU_FAST_MATMUL``: exact fp32 by default, TF32 for "high" and
    "1" (the JAX package's 3-pass bf16 and raw bf16 tiers)."""
    environ = {} if value is None else {"GPFLOW_TPU_FAST_MATMUL": value}
    try:
        config.apply_environment_tiers(environ)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32 and torch.backends.cudnn.allow_tf32 is tf32
        assert torch.get_float32_matmul_precision() == ("high" if tf32 else "highest")
    finally:
        config.apply_environment_tiers({})
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("switch, env, dtype, expected", [
    (None, None, torch.float32, False),  # auto: CUDA tensors only
    (None, "0", torch.float32, False),
    (None, "false", torch.float32, False),
    (None, "False", torch.float32, False),
    (None, "1", torch.float32, True),
    (None, "yes", torch.bfloat16, True),
    (None, "1", torch.float64, False),  # float64 never reaches the kernels
    (False, "1", torch.float32, False),  # the programmatic switch wins
    (True, "0", torch.float32, True),
])
def test_kernel_switch_reads_the_environment(switch, env, dtype, expected):
    """``GPFLOW_TPU_PALLAS`` decides where ``set_pallas_enabled`` is None,
    as ``gpflow_tpu/ops/pallas_distance.py:57-75``."""
    environ = {} if env is None else {"GPFLOW_TPU_PALLAS": env}
    before = pd.get_pallas_enabled()
    try:
        pd.set_pallas_enabled(switch)
        with mock.patch.dict("os.environ", environ):
            if env is None:
                os.environ.pop("GPFLOW_TPU_PALLAS", None)
            assert pd.pallas_available(dtype) is expected
            assert pd._routes_to_kernel(torch.zeros(2, 2, dtype=dtype)) is expected
    finally:
        pd.set_pallas_enabled(before)


def test_environment_in_one_process():
    """Every override and tier set in the environment before the import, in
    one subprocess: the port's config equals the JAX package's, TF32 is on
    for "high", the kernels are off for "0" unless switched on, the JAX
    package's shape-check switch turns the port's checks on, and the port
    imports no JAX."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("GPFLOW_", "JAX_DEFAULT_MATMUL"))}
    env.update({
        "GPFLOW_INT": "int16", "GPFLOW_FLOAT": "float32", "GPFLOW_POSITIVE_BIJECTOR": "exp",
        "GPFLOW_POSITIVE_MINIMUM": "1e-3", "GPFLOW_LIKELIHOOD_POSITIVE_MINIMUM": "5e-4",
        "GPFLOW_SUMMARY_FMT": "simple", "GPFLOW_JITTER": "1e-2", "GPFLOW_TPU_FAST_MATMUL": "high",
        "GPFLOW_TPU_DISABLE_X64": "1", "GPFLOW_TPU_PALLAS": "0", "GPFLOW_TPU_CHECK_SHAPES": "1",
        "JAX_PLATFORMS": "cpu",
    })
    code = (
        "import json, sys, dataclasses, numpy as np, torch\n"
        "import gpflow_tpu_torch as gt\n"
        "from gpflow_tpu_torch import config\n"
        "from gpflow_tpu_torch.ops import pallas_distance as pd\n"
        "from gpflow_tpu_torch.utilities import get_enable_check_shapes\n"
        "no_jax = not any(m.split('.')[0] in ('jax', 'gpflow_tpu') for m in sys.modules)\n"
        "name = lambda v: str(v).replace('torch.', '') if isinstance(v, torch.dtype) else v\n"
        "out = {'no_jax': no_jax, 'torch': {k: name(v) for k, v in dataclasses.asdict(config.config()).items()"
        " if k != 'device'}}\n"
        "X = torch.zeros(2, 2)\n"
        "out['tiers'] = [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,\n"
        "                torch.get_float32_matmul_precision(), get_enable_check_shapes(), pd.pallas_available(X.dtype)]\n"
        "pd.set_pallas_enabled(True)\n"
        "out['tiers'] += [pd.pallas_available(X.dtype), pd.pallas_available(torch.float64)]\n"
        "config.set_default_float(torch.float64)\n"
        "out['jitter after float64'] = config.default_jitter()\n"
        "out['positive'] = repr(gt.bijectors.positive())\n"
        "import os\n"
        "os.environ.pop('GPFLOW_SUMMARY_FMT')  # the JAX package raises NameError at import with it set\n"
        "import jax, gpflow_tpu\n"
        "from gpflow_tpu import config as jc\n"
        "from gpflow_tpu.utilities.shapes import get_enable_check_shapes as jax_checks\n"
        "jname = lambda v: np.dtype(v).name if isinstance(v, type) and issubclass(v, np.generic) else v\n"
        "out['jax'] = {k: jname(v) for k, v in dataclasses.asdict(jc.config()).items()}\n"
        "out['jax tiers'] = [jax.config.jax_enable_x64, jax.config.jax_default_matmul_precision, jax_checks()]\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["no_jax"]
    want = {"int": "int16", "float": "float32", "jitter": 1e-2, "positive_bijector": "exp",
            "positive_minimum": 1e-3, "likelihood_positive_minimum": 5e-4, "summary_fmt": "simple"}
    assert out["torch"] == want
    assert out["jax"] == {**want, "summary_fmt": "fancy_grid"}
    # TF32 for "high"; shape checks on through GPFLOW_TPU_CHECK_SHAPES; the
    # kernels off for "0", on where switched on, never for float64
    assert out["tiers"] == [True, True, "high", True, False, True, False]
    assert out["jitter after float64"] == 1e-2  # an environment jitter is explicit
    assert out["positive"] == "Chain(bijectors=(Shift(shift=0.001), Exp()))"
    assert out["jax tiers"] == [False, "high", True]


def test_versions_ci_utils_and_experimental():
    assert gpflow_tpu_torch.__version__ == gpflow_tpu.__version__
    for env in ({}, {"CI": "1"}, {"CI": "1", "DOCS": "1"}):
        with mock.patch.dict("os.environ", env, clear=True):
            assert ci_utils.is_continuous_integration() == gpflow_tpu.ci_utils.is_continuous_integration()
            assert ci_utils.reduce_in_tests(100, 3) == gpflow_tpu.ci_utils.reduce_in_tests(100, 3)

    class A: pass  # noqa: E701
    class B(A): pass  # noqa: E701
    class C(B): pass  # noqa: E701
    class D(A): pass  # noqa: E701

    assert list(ci_utils.subclasses(A)) == list(gpflow_tpu.ci_utils.subclasses(A)) == [C, B, D]

    def twice(x):
        """Doubles."""
        return 2 * x

    for decorate in (experimental, gpflow_tpu.experimental.utils.experimental):
        f = decorate(twice)
        assert f.__name__ == "twice" and f.__doc__ == "Doubles."
        with pytest.warns(UserWarning, match="experimental"):
            assert f(2) == 4
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert f(3) == 6

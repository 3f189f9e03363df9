"""Kernel K1 of gpflow_tpu_torch on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode), and the plumbing around the CUDA
kernel that can be checked without a card. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflow_tpu import kernels as jax_kernels
from gpflow_tpu.ops.pallas_distance import PALLAS_FAMILIES as JAX_FAMILIES
from gpflow_tpu.ops.pallas_distance import _stationary_pallas_forward
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.ops import cuda_build
from gpflow_tpu_torch.ops import pallas_distance as pd

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

REPO = Path(__file__).resolve().parent.parent


def test_families_match_the_jax_package():
    assert pd.PALLAS_FAMILIES == JAX_FAMILIES


@pytest.mark.parametrize("N,M,D", [(33, 21, 4), (24, 64, 1), (100, 50, 5)])
@pytest.mark.parametrize("family", JAX_FAMILIES)
def test_plain_k1_matches_jax_pallas_kernel_f32(family, N, M, D):
    # the JAX Pallas tests' own tolerance (tests/gpflow_tpu/test_pallas_ops.py:115)
    rng = np.random.RandomState(N + M + D)
    Xs = rng.randn(N, D).astype(np.float32)
    Zs = rng.randn(M, D).astype(np.float32)
    var = np.float32(1.7)
    alpha = np.float32(1.3)
    expected = np.asarray(_stationary_pallas_forward(
        family, jnp.asarray(Xs), jnp.asarray(Zs), jnp.asarray(var),
        jnp.asarray(alpha) if family == "rq" else None, interpret=True,
    ))
    got = pd.stationary_forward(
        family, torch.from_numpy(Xs), torch.from_numpy(Zs), torch.tensor(var),
        torch.tensor(alpha) if family == "rq" else None,
    )
    assert got.dtype == torch.float32 and got.shape == (N, M)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


def test_plain_k1_bf16_inputs_compute_in_f32():
    rng = np.random.RandomState(1)
    Xs = torch.from_numpy(rng.randn(17, 3).astype(np.float32)).to(torch.bfloat16)
    Zs = torch.from_numpy(rng.randn(9, 3).astype(np.float32)).to(torch.bfloat16)
    got = pd.stationary_forward("rbf", Xs, Zs, torch.tensor(1.5))
    want = pd.stationary_forward("rbf", Xs.float(), Zs.float(), torch.tensor(1.5))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("same_inputs", [False, True])
def test_kernel_matrix_rbf_matches_squared_exponential_f64(same_inputs):
    # f64 to round-off: both sides are the norm-expansion distance + exp
    rng = np.random.RandomState(2)
    X = rng.rand(30, 4) * 4
    Z = X if same_inputs else rng.rand(20, 4) * 4
    ls = np.array([0.5, 1.0, 1.5, 2.0])
    expected = np.asarray(jax_kernels.SquaredExponential(variance=1.3, lengthscales=ls).K(X, Z))
    got = pd.stationary_kernel_matrix(
        torch.from_numpy(X), torch.from_numpy(Z), torch.from_numpy(ls), torch.tensor(1.3, dtype=torch.float64)
    )
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-12, atol=1e-14)


def test_kernel_matrix_rejects_unknown_family_and_rq_without_alpha():
    X = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="Unknown stationary family"):
        pd.stationary_kernel_matrix(X, X, torch.tensor(1.0), torch.tensor(1.0), "cosine")
    with pytest.raises(ValueError, match="requires alpha"):
        pd.stationary_kernel_matrix(X, X, torch.tensor(1.0), torch.tensor(1.0), "rq")


def test_only_cuda_f32_or_bf16_routes_to_the_kernel():
    assert not pd.pallas_available(torch.zeros(2, 2, dtype=torch.float32))
    assert not pd.pallas_available(torch.zeros(2, 2, dtype=torch.float64))
    assert not pd.pallas_available(torch.zeros(2, 2, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launch_counter_stays_zero_on_cpu(dtype):
    rng = np.random.RandomState(3)
    before = pd.launch_counts["K1"]
    model = SVGP(
        kernel=kernels.SquaredExponential(lengthscales=np.ones(2)),
        likelihood=likelihoods.Gaussian(0.1),
        inducing_variable=rng.rand(16, 2),
    ).to(dtype)
    X = torch.from_numpy(rng.rand(24, 2)).to(dtype)
    with torch.no_grad():
        model.posterior().predict_f(X)
        model.predict_y(X)
    assert pd.launch_counts["K1"] == before == 0


def test_cuda_wrapper_raises_on_cpu_tensors():
    X = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pd.stationary_forward_cuda("rbf", X, X, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="Unknown stationary family"):
        pd.stationary_forward_cuda("cosine", X, X, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="requires alpha"):
        pd.stationary_forward_cuda("rq", X, X, torch.tensor([1.0]))
    assert pd.launch_counts["K1"] == 0


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", Path("/nonexistent-build-dir"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("gpflow_k1_probe", ["stationary_k1.cu"])


def _run_python(code: str, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )


def test_import_leaves_jax_out():
    code = (
        "import sys, gpflow_tpu_torch, gpflow_tpu_torch.models, gpflow_tpu_torch.ops.pallas_distance\n"
        "import gpflow_tpu_torch.parallel, gpflow_tpu_torch.kullback_leiblers\n"
        "from gpflow_tpu_torch.models import GPR\n"
        "from gpflow_tpu_torch.optimizers import Scipy\n"
        "import gpflow_tpu_torch.quadrature, gpflow_tpu_torch.likelihoods.scalar_discrete\n"
        "import gpflow_tpu_torch.optimizers.natgrad\n"
        "from gpflow_tpu_torch.models import CGLB, GPRFITC, SGPR, cglb_conjugate_gradient\n"
        "from gpflow_tpu_torch.posteriors import SGPRPosterior\n"
        "from gpflow_tpu_torch.utilities import to_default_float\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gpflow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run_python(code, dict(os.environ))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_module_imports_and_runs_plain_path_without_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent-cuda")
    code = (
        "import torch\n"
        "from gpflow_tpu_torch.ops import pallas_distance as pd\n"
        "K = pd.stationary_forward('rbf', torch.zeros(3, 2), torch.ones(4, 2), torch.tensor(2.0))\n"
        "assert K.shape == (3, 4) and pd.launch_counts['K1'] == 0\n"
        "print('ok')\n"
    )
    proc = _run_python(code, env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

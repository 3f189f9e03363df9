"""Kernel K1 of gpflow_tpu_torch on the CPU: its plain version against the JAX
package's Pallas kernel (interpret mode), and the plumbing around the CUDA
kernel that can be checked without a card. The CUDA kernel itself is held
against the plain version on the card by chip_smoke.py."""
import ctypes
import os
import re
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

from chip_smoke import K1_SHAPES

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
    assert not pd.pallas_available(torch.float32) and not pd._routes_to_kernel(torch.zeros(2, 2, dtype=torch.float32))
    assert not pd.pallas_available(torch.float64) and not pd._routes_to_kernel(torch.zeros(2, 2, dtype=torch.float64))
    assert not pd.pallas_available(torch.bfloat16) and not pd._routes_to_kernel(torch.zeros(2, 2, dtype=torch.bfloat16))


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
        "import gpflow_tpu_torch.utilities.shapes, gpflow_tpu_torch.utilities.parameter_or_function\n"
        "import gpflow_tpu_torch.functions, gpflow_tpu_torch.mean_functions\n"
        "import gpflow_tpu_torch.kernels.linears, gpflow_tpu_torch.kernels.statics, gpflow_tpu_torch.kernels.periodic\n"
        "import gpflow_tpu_torch.conditionals.dispatch, gpflow_tpu_torch.conditionals.conditionals\n"
        "from gpflow_tpu_torch.models import VGP, VGPOpperArchambeau, SVGP_deprecated, training_loss_closure\n"
        "from gpflow_tpu_torch.models.vgp import update_vgp_data\n"
        "from gpflow_tpu_torch.posteriors import VGPPosterior\n"
        "import gpflow_tpu_torch.kernels.multioutput.kernels, gpflow_tpu_torch.kernels.misc\n"
        "import gpflow_tpu_torch.inducing_variables.multioutput.inducing_variables\n"
        "import gpflow_tpu_torch.inducing_variables.inducing_patch\n"
        "import gpflow_tpu_torch.covariances.multioutput.kuus, gpflow_tpu_torch.covariances.multioutput.kufs\n"
        "import gpflow_tpu_torch.conditionals.multioutput.conditionals\n"
        "from gpflow_tpu_torch.conditionals.util import mix_latent_gp, independent_interdomain_conditional\n"
        "from gpflow_tpu_torch.posteriors import LinearCoregionalizationPosterior, FallbackIndependentLatentPosterior\n"
        "from gpflow_tpu_torch.utilities.ops import leading_transpose\n"
        "import gpflow_tpu_torch.priors, gpflow_tpu_torch.conditionals.sample_conditionals\n"
        "import gpflow_tpu_torch.conditionals.multioutput.sample_conditionals\n"
        "from gpflow_tpu_torch import PriorOn, set_trainable\n"
        "from gpflow_tpu_torch.models import GPMC, SGPMC\n"
        "from gpflow_tpu_torch.optimizers import SamplingHelper, run_hmc\n"
        "from gpflow_tpu_torch.conditionals.util import sample_mvn\n"
        "from gpflow_tpu_torch.utilities import select_dict_parameters_with_prior\n"
        "import gpflow_tpu_torch.expectations, gpflow_tpu_torch.probability_distributions\n"
        "import gpflow_tpu_torch.expectations.dispatch, gpflow_tpu_torch.expectations.expectations\n"
        "import gpflow_tpu_torch.expectations.quadratures, gpflow_tpu_torch.expectations.squared_exponentials\n"
        "import gpflow_tpu_torch.expectations.linears, gpflow_tpu_torch.expectations.mean_functions\n"
        "import gpflow_tpu_torch.expectations.misc, gpflow_tpu_torch.expectations.sums\n"
        "import gpflow_tpu_torch.expectations.products, gpflow_tpu_torch.expectations.cross_kernels\n"
        "import gpflow_tpu_torch.conditionals.uncertain_conditionals\n"
        "from gpflow_tpu_torch.conditionals import uncertain_conditional\n"
        "from gpflow_tpu_torch.models import GPLVM, BayesianGPLVM\n"
        "from gpflow_tpu_torch.utilities.ops import pca_reduce\n"
        "from gpflow_tpu_torch.base import InputData, OutputData, RegressionData\n"
        "import gpflow_tpu_torch.kernels.convolutional, gpflow_tpu_torch.kernels.changepoints\n"
        "import gpflow_tpu_torch.kernels.categorical\n"
        "from gpflow_tpu_torch.kernels import Categorical, ChangePoints, Convolutional\n"
        "from gpflow_tpu_torch.covariances.kuus import Kuu_conv_patch\n"
        "from gpflow_tpu_torch.covariances.kufs import Kuf_conv_patch\n"
        "import gpflow_tpu_torch.utilities.serving, gpflow_tpu_torch.utilities.bucketing\n"
        "import gpflow_tpu_torch.utilities.checkpoints, gpflow_tpu_torch.parallel.trainer\n"
        "from gpflow_tpu_torch.utilities import export_serving, load_serving, bucketize, save_checkpoint\n"
        "from gpflow_tpu_torch.utilities import multiple_assign, freeze, deepcopy, reset_cache_bijectors\n"
        "from gpflow_tpu_torch.ops import set_pallas_enabled, get_pallas_enabled, rbf_kernel_matrix\n"
        "from gpflow_tpu_torch.ops import scaled_squared_distance\n"
        "import gpflow_tpu_torch.monitor, gpflow_tpu_torch.monitor.base, gpflow_tpu_torch.monitor.tensorboard\n"
        "import gpflow_tpu_torch.experimental.utils, gpflow_tpu_torch.ci_utils, gpflow_tpu_torch.versions\n"
        "import gpflow_tpu_torch.utilities.bijectors, gpflow_tpu_torch.utilities.profiling\n"
        "from gpflow_tpu_torch.utilities import training_loop, print_summary, traverse_module, annotate, profile\n"
        "from gpflow_tpu_torch.posteriors import PrecomputedValue, get_precomputed_value_shape\n"
        "from gpflow_tpu_torch.base import capture_parameter_reads, TensorType\n"
        "from gpflow_tpu_torch.bijectors import FillTriangular, triangular_size\n"
        "from gpflow_tpu_torch import monitor, quadrature, experimental, default_float, __version__\n"
        "import gpflow_tpu_torch.logdensities, gpflow_tpu_torch.likelihoods.utils, gpflow_tpu_torch.likelihoods.base\n"
        "import gpflow_tpu_torch.likelihoods.scalar_continuous, gpflow_tpu_torch.quadrature.gauss_hermite\n"
        "import gpflow_tpu_torch.parallel.mesh, gpflow_tpu_torch.parallel.sharded, gpflow_tpu_torch._sharding\n"
        "from gpflow_tpu_torch.parallel import make_mesh, make_hybrid_mesh, shard_internal_data, sharded_predict_f\n"
        "import gpflow_tpu_torch.quadrature.base, gpflow_tpu_torch.utilities.model_utils, gpflow_tpu_torch.utilities.ops\n"
        "import gpflow_tpu_torch.models.training_mixins, gpflow_tpu_torch.models.model, gpflow_tpu_torch.models.gpr\n"
        "import gpflow_tpu_torch.models.sgpr, gpflow_tpu_torch.models.cglb, gpflow_tpu_torch.models.gplvm\n"
        "import gpflow_tpu_torch.inducing_variables.inducing_variables, gpflow_tpu_torch.kernels.base\n"
        "import torch, gpflow_tpu_torch._compile, gpflow_tpu_torch._optim, gpflow_tpu_torch.optimizers.mcmc\n"
        "from gpflow_tpu_torch._compile import TraceError, jit, lift_constants, trace\n"
        "assert jit(lambda x: x * 2)(torch.ones(2)).tolist() == [2.0, 2.0]\n"
        "assert gpflow_tpu_torch.probability_distributions.Gaussian and gpflow_tpu_torch.expectations.expectation\n"
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


# Launch plans on an H100 (132 SMs) with resident blocks per SM of the order
# the kernels get (more for short tiles and for the edge path, which keeps no
# tile buffers): the plan's rules, the card's numbers stand-ins.
SMS = 132


def _resident(rows, tma):
    return {64: 3, 32: 5, 16: 8}[rows] + (0 if tma else 1)


def _plan(kernel, N, M, D, out_ptr=256, g_ptr=512, xs_ptr=1024, zs_ptr=2048, itemsize=4):
    return pd._launch_plan(kernel, N, M, D, out_ptr, g_ptr, SMS, _resident, xs_ptr, zs_ptr, itemsize)


def _tile_origins(plan, M, block):
    """(row, column) of the first output of each tile that ``block`` computes:
    row-major tiles from ``block`` on with stride ``plan.grid``, the kernels'
    walk (``TileGrid`` in ``csrc/stationary_tile.cuh``)."""
    tiles_m = -(-M // pd._TILE_COLS)
    return [(t // tiles_m * plan.tile_rows, t % tiles_m * pd._TILE_COLS) for t in range(block, plan.tiles, plan.grid)]


def check_plan_covers(plan, N, M):
    """The grid fits the card and the tiles, and the blocks' walks cover the
    [N, M] output with tiles exactly once."""
    assert 1 <= plan.grid <= min(plan.tiles, SMS * _resident(plan.tile_rows, plan.tma))
    assert plan.tile_rows in pd._TILE_ROWS
    origins = [o for block in range(plan.grid) for o in _tile_origins(plan, M, block)]
    assert len(origins) == len(set(origins)) == plan.tiles
    rows = sorted({r for r, _ in origins})
    cols = sorted({c for _, c in origins})
    assert rows == list(range(0, N, plan.tile_rows)) and cols == list(range(0, M, pd._TILE_COLS))
    assert len(rows) * len(cols) == plan.tiles


EDGE_SHAPES = [(1000, 777, 8), (517, 1030, 8), (1999, 2051, 8), (64, 128, 8), (3, 4, 8), (70000, 5, 2)]


@pytest.mark.parametrize("N,M,D", K1_SHAPES + EDGE_SHAPES)
def test_k1_launch_plan_covers_every_shape(N, M, D):
    plan = _plan("K1", N, M, D)
    check_plan_covers(plan, N, M)
    assert plan.tma == (M % 4 == 0)
    assert plan.vec == (D % 4 == 0)
    # a misaligned output (a view 4 bytes in) leaves the TMA path, misaligned
    # inputs the vector loads; the tiles stay the same
    off = _plan("K1", N, M, D, out_ptr=260, xs_ptr=1028)
    assert not off.tma and not off.vec and off.tile_rows == plan.tile_rows
    assert _plan("K1", N, M, D, zs_ptr=2056).vec is False
    # bfloat16 inputs need four-element (8-byte) alignment only
    assert _plan("K1", N, M, D, xs_ptr=1032, zs_ptr=2056, itemsize=2).vec == (D % 4 == 0)


def test_k1_launch_plan_spreads_the_smallest_path_shape():
    # the natural-gradient Kuu, the smallest shape a path launches
    plan = _plan("K1", 1024, 1024, 8)
    assert plan.tiles >= 2 * SMS and plan.grid >= SMS
    # a shape with tiles to spare keeps the tallest tile, and the grid stays
    # within what the card keeps resident
    big = _plan("K1", 32768, 4096, 8)
    assert big.tile_rows == pd._TILE_ROWS[0] and big.grid == SMS * _resident(big.tile_rows, True)
    # a grid of blocks as wide as the data: more row strips than the 65535 a
    # two-dimensional grid allowed
    tall = _plan("K1", 64 * 70000, 128, 8)
    assert tall.tiles == 70000 and tall.grid == SMS * _resident(tall.tile_rows, True)


def test_launch_plan_raises_without_resident_blocks():
    with pytest.raises(RuntimeError, match="resident"):
        pd._launch_plan("K1", 8, 8, 8, 256, None, SMS, lambda rows, tma: 0, 256, 256, 4)


def _c_params(source, fn):
    text = (REPO / "gpflow_tpu_torch" / "csrc" / source).read_text()
    match = re.search(rf'extern "C" int {fn}\(([^)]*)\)', text)
    assert match, fn
    return [p.strip() for p in match.group(1).split(",")]


def _ctype(param):
    if param.startswith("int*") or param.startswith("int *"):
        return ctypes.POINTER(ctypes.c_int)
    if "*" in param:
        return ctypes.c_void_p
    assert param.startswith("int "), param
    return ctypes.c_int


@pytest.mark.parametrize("kernel,source,launch", [("gpflow_k1", "stationary_k1.cu", "stationary_forward"),
                                                  ("gpflow_k2", "stationary_k2.cu", "stationary_wgrad")])
def test_ctypes_signatures_match_the_c_entry_points(kernel, source, launch):
    class Lib:
        pass

    lib = Lib()
    for name in (f"{kernel}_{launch}", f"{kernel}_occupancy"):
        setattr(lib, name, type("Fn", (), {})())
    pd._bind(lib, kernel, launch)
    for name in (f"{kernel}_{launch}", f"{kernel}_occupancy"):
        fn = getattr(lib, name)
        assert fn.argtypes == [_ctype(p) for p in _c_params(source, name)], name
        assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("source", ["stationary_k1.cu", "stationary_k2.cu"])
def test_tile_heights_match_the_cuda_sources(source):
    # the tile heights each library dispatches on (kernel_for's cases), tallest first
    text = (REPO / "gpflow_tpu_torch" / "csrc" / source).read_text()
    assert tuple(int(r) for r in re.findall(r"case (\d+): \*smem", text)) == pd._TILE_ROWS
    header = (REPO / "gpflow_tpu_torch" / "csrc" / "stationary_tile.cuh").read_text()
    assert "kTileM = kThreadsX * kColsPerThread" in header and pd._TILE_COLS == 32 * 4


@pytest.mark.parametrize("switch", [None, False])
def test_the_switch_sends_cpu_tensors_to_the_plain_version(switch):
    X = torch.from_numpy(np.random.RandomState(4).rand(5, 2).astype(np.float32))
    pd.set_pallas_enabled(switch)
    try:
        assert not pd.pallas_available(X.dtype) and not pd._routes_to_kernel(X)
        K = pd.stationary_forward("matern52", X, X, torch.tensor(1.3))
        W = pd.stationary_wgrad("matern52", X, X, torch.tensor(1.3), torch.ones(5, 5))
    finally:
        pd.set_pallas_enabled(None)
    np.testing.assert_array_equal(K.numpy(), pd.stationary_forward_plain("matern52", X, X, torch.tensor(1.3)).numpy())
    assert W.shape == (5, 5) and pd.launch_counts == {"K1": 0, "K2": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_forced_switch_raises_on_a_cpu_tensor(dtype):
    X = torch.zeros(4, 2, dtype=dtype)
    pd.set_pallas_enabled(True)
    try:
        assert pd.get_pallas_enabled() is True and pd.pallas_available(X.dtype) and pd._routes_to_kernel(X)
        with pytest.raises(ValueError, match="CUDA tensors"):
            pd.stationary_forward("rbf", X, X, torch.tensor([1.0]))
        with pytest.raises(ValueError, match="CUDA tensors"):
            pd.stationary_wgrad("matern52", X, X, torch.tensor([1.0]), torch.ones(4, 4))
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.SquaredExponential().K(X)
    finally:
        pd.set_pallas_enabled(None)
    assert pd.get_pallas_enabled() is None and pd.launch_counts == {"K1": 0, "K2": 0}


@pytest.mark.parametrize("switch", [None, True, False])
def test_float64_never_reaches_the_kernels(switch):
    X = torch.zeros(3, 2, dtype=torch.float64)
    pd.set_pallas_enabled(switch)
    try:
        assert not pd.pallas_available(X.dtype) and not pd._routes_to_kernel(X)
        assert pd.stationary_forward("rbf", X, X, torch.tensor(1.0, dtype=torch.float64)).dtype == torch.float64
    finally:
        pd.set_pallas_enabled(None)


def test_the_ops_are_registered_with_fake_implementations():
    k1, k2 = torch.ops.gpflow_tpu_torch.stationary_k1, torch.ops.gpflow_tpu_torch.stationary_k2
    Xs, Zs = torch.empty(6, 3, device="meta"), torch.empty(9, 3, device="meta")
    var = torch.empty(1, device="meta")
    K = k1("rbf", Xs, Zs, var, None)
    W = k2("matern52", Xs.to(torch.bfloat16), Zs.to(torch.bfloat16), var, torch.empty(6, 9, device="meta"))
    for out in (K, W):
        assert out.device.type == "meta" and out.shape == (6, 9) and out.dtype == torch.float32
    assert pd.launch_counts == {"K1": 0, "K2": 0}
    with pytest.raises(NotImplementedError):
        k1("rbf", torch.zeros(2, 3), torch.zeros(2, 3), torch.ones(1), None)  # no CPU implementation


def test_public_names_match_the_jax_package():
    from gpflow_tpu.ops import pallas_distance as jax_pd

    rng = np.random.RandomState(5)
    X, Z, ls = rng.rand(7, 3), rng.rand(4, 3), np.array([0.5, 1.0, 2.0])
    got = pd.rbf_kernel_matrix(torch.from_numpy(X), torch.from_numpy(Z), torch.from_numpy(ls),
                               torch.tensor(1.3, dtype=torch.float64))
    # the JAX function always takes its Pallas kernel, which runs on a TPU only: its kernel class instead
    want = jax_kernels.SquaredExponential(variance=1.3, lengthscales=ls).K(X, Z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    got = pd.scaled_squared_distance(torch.from_numpy(X / ls), torch.from_numpy(Z / ls))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pd.scaled_squared_distance(X / ls, Z / ls)),
                               rtol=1e-12, atol=1e-14)

"""The JAX package's own tests of the kernels, covariances, likelihoods and densities, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: one process
runs the files below once, and each JAX test node is one case here."""
import pytest

from . import test_torch_reference_plugin as reference
from .test_torch_environment import one_thread  # noqa: F401

FILES = [
    "tests/gpflow_tpu/covariances/test_covariances.py",
    "tests/gpflow_tpu/covariances/test_multioutput.py",
    "tests/gpflow_tpu/kernels/test_broadcasting_full.py",
    "tests/gpflow_tpu/kernels/test_multioutput.py",
    "tests/gpflow_tpu/kernels/test_psd_and_broadcasting.py",
    "tests/gpflow_tpu/likelihoods/test_function_params.py",
    "tests/gpflow_tpu/likelihoods/test_heteroskedastic.py",
    "tests/gpflow_tpu/likelihoods/test_switched_likelihood.py",
    "tests/gpflow_tpu/test_expectations_markov.py",
    "tests/gpflow_tpu/test_functions.py",
    "tests/gpflow_tpu/test_functions_depth.py",
    "tests/gpflow_tpu/test_inducing_variables.py",
    "tests/gpflow_tpu/test_logdensities.py",
]


# Seconds for the process: it took 24-42 s in the tier-1 run.
LIMIT = 130


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"), LIMIT)


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

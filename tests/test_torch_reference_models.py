"""The JAX package's own tests of the models and optimizers, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: two processes
side by side run the files below once, and each JAX test node is one case
here."""
import pytest

from . import test_torch_reference_plugin as reference
from .test_torch_environment import one_thread  # noqa: F401

FILES = [
    "tests/gpflow_tpu/models/test_fuzz_objectives.py",
    "tests/gpflow_tpu/models/test_model_posterior_equivalence.py",
    "tests/gpflow_tpu/models/test_model_predict.py",
    "tests/gpflow_tpu/models/test_objective_oracles.py",
    "tests/gpflow_tpu/models/test_variational.py",
    "tests/gpflow_tpu/optimizers/test_scipy_depth.py",
    "tests/gpflow_tpu/test_natural_gradients.py",
    "tests/integration/test_bo_integration.py",
    "tests/integration/test_method_equivalence.py",
]


# Two processes side by side, each half of the tests: alone the area took
# 46.6 s in one process and 24.3 s in two.
SHARDS = 2
# Seconds for the two: about 3x their 28 s in the tier-1 run.
LIMIT = 90


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"), LIMIT, SHARDS)


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

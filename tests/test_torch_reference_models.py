"""The JAX package's own tests of the models and optimizers, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: one process
runs the files below once, and each JAX test node is one case here."""
import pytest

from . import test_torch_reference_plugin as reference

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


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"))


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

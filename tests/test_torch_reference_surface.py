"""The JAX package's own tests of the public surface: modules, priors, config and serving, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: one process
runs the files below once, and each JAX test node is one case here."""
import pytest

from . import test_torch_reference_plugin as reference
from .test_torch_environment import one_thread  # noqa: F401

FILES = [
    "tests/gpflow_tpu/test_all.py",
    "tests/gpflow_tpu/test_base_prior.py",
    "tests/gpflow_tpu/test_config.py",
    "tests/gpflow_tpu/test_experimental.py",
    "tests/gpflow_tpu/utilities/test_serving.py",
    "tests/gpflow_tpu/utilities/test_traversal_depth.py",
    "tests/integration/test_api_surface.py",
    "tests/integration/test_checkpoints.py",
]


# Seconds for the process: it took 25-46 s in the tier-1 run.
LIMIT = 140


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"), LIMIT)


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

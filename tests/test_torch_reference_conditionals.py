"""The JAX package's own tests of the conditionals, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: one process
runs the files below once, and each JAX test node is one case here."""
import pytest

from . import test_torch_reference_plugin as reference
from .test_torch_environment import one_thread  # noqa: F401

FILES = [
    "tests/gpflow_tpu/conditionals/test_broadcasted_conditionals.py",
    "tests/gpflow_tpu/conditionals/test_fuzz_conditionals.py",
    "tests/gpflow_tpu/conditionals/test_fuzz_multioutput.py",
    "tests/gpflow_tpu/conditionals/test_multioutput.py",
]


# Seconds for the process: it took 18-24 s in the tier-1 run.
LIMIT = 75


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"), LIMIT)


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

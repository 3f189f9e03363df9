"""The JAX package's own tests of the monitor and the documentation examples, run on the port
through the alias of ``tests/test_torch_reference_plugin.py``: one process
runs the files below once, and each JAX test node is one case here."""
import pytest

from . import test_torch_reference_plugin as reference

FILES = [
    "tests/gpflow_tpu/test_monitor.py",
    "tests/integration/test_examples.py",
]


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    return reference.run(FILES, tmp_path_factory.mktemp("reference"))


def test_the_run_holds_the_committed_nodes(outcomes):
    assert sorted(outcomes) == sorted(reference.committed_nodes(FILES))


@pytest.mark.parametrize("node", reference.committed_nodes(FILES))
def test_on_the_port(node, outcomes):
    reference.check(node, outcomes)

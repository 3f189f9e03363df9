"""What the port's test modules share of their setting: one thread of
torch's intra-op pool, and the compiler options of their JAX references.

Each ``tests/test_torch_*.py`` imports the module fixture ``one_thread``
(autouse), which holds torch at ``THREADS`` threads while the module's
tests and module fixtures run. The tier-1 run puts 6 pytest workers on the
host's cores beside JAX's own pools and the rank and conformance processes
that the port's files start. At torch's default, a thread a core, every
parallel region then waits for threads that other processes hold: a small op
that takes microseconds alone takes milliseconds. With the suite beside it,
the port's CGLB example at 200 points took 139 s with 8 threads and 7.4 s
with 1 (2 threads: 9.1 s); alone the thread count moved the port's files by
no more than their spread. The tests' arrays are small.

The translated files hold the same count through
``test_torch_translated_support.translated_test_environment``; the rank
processes and the conformance processes set it themselves. The conformance
plugin (``test_torch_reference_plugin.py``) imports no fixture: loaded as a
plugin, its fixtures would reach every module of the conformance process.

``reference_jit`` is ``jax.jit`` for the JAX package's side of a comparison:
the function traced once and compiled by XLA with its backend optimisations
off (``FAST_COMPILE``). Run eagerly, each new primitive at each new shape is
a compile of its own, and XLA's compiles took most of the port's CPU tests
(56% of their samples alone, 13 of 28 s of the VGP ELBO tests); one program
a call, compiled without LLVM's costly passes, took 22% less than the same
program at the default level (the multioutput SVGP tests, 47.9 against 37.4
s). The options are part of the jit's compile cache key, so the JAX
package's own tests in the same process keep their compiles. The results
differ from the default level's in the last bits only, far inside every
tolerance that holds the port to them.
"""
import ast
import pathlib

import pytest
import torch

THREADS = 1
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def reference_jit(fun=None, **kwargs):
    """``jax.jit(fun, **kwargs)`` compiled with ``FAST_COMPILE``; as a
    decorator with keywords too. JAX is imported here, not at the top: the
    rank processes of ``test_torch_parallel.py`` import that module, and it
    this one, without JAX."""
    import jax

    if fun is None:
        return lambda f: reference_jit(f, **kwargs)
    return jax.jit(fun, compiler_options=FAST_COMPILE, **kwargs)


def _imports_and_tests(path):
    """The (module, name) pairs that ``path`` imports at its top, and
    whether it defines a test."""
    body = ast.parse(path.read_text()).body
    names = {(node.module, alias.name) for node in body if isinstance(node, ast.ImportFrom) for alias in node.names}
    return names, any(isinstance(node, ast.FunctionDef) and node.name.startswith("test_") for node in body)


def test_every_port_test_module_holds_one_thread():
    """Each port test module that holds tests imports ``one_thread``, or
    the translated files' environment, which sets the same count; the
    conformance plugin runs its JAX files in processes of one thread
    (``SERIAL``)."""
    here = pathlib.Path(__file__)
    missing = []
    for path in sorted(here.parent.glob("test_torch_*.py")):
        names, has_tests = _imports_and_tests(path)
        if path == here or path.name == "test_torch_reference_plugin.py" or not has_tests:
            continue
        if ("test_torch_environment", "one_thread") not in names and (
                "test_torch_translated_support", "translated_test_environment") not in names:
            missing.append(path.name)
    assert missing == []

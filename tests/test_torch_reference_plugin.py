"""A pytest plugin that runs the JAX package's own jax-free tests on the port.

Loaded with ``-p tests.test_torch_reference_plugin`` in a pytest process of
its own, with ``--noconftest`` (``tests/conftest.py`` imports jax), it:

* resolves ``gpflow_tpu`` and every ``gpflow_tpu.<sub>`` to
  ``gpflow_tpu_torch.<sub>`` through a meta-path alias, and asserts that
  ``sys.modules["gpflow_tpu"]`` is the port, so that no module of the JAX
  package is loaded in the process;
* builds on ``config.set_default_device`` of ``GPFLOW_TPU_TORCH_REFERENCE_DEVICE``
  ("cpu" unless set) and turns the shape checks on, as ``tests/conftest.py``
  does for the JAX package;
* defines the ``rng`` fixture as ``tests/conftest.py`` does;
* deselects the tests marked ``slow``, as tier-1 does;
* keeps the ``i``-th of every ``k`` tests it collects where
  ``GPFLOW_TPU_TORCH_REFERENCE_SHARD`` reads ``i/k`` (``run``'s shards);
* writes each test's outcome by node id to the JSON file named by
  ``GPFLOW_TPU_TORCH_REFERENCE_REPORT``, where one is named ("xfailed" for
  a test that fails as its strict xfail mark expects);
* writes the process's default device and kernel launch counts at its end
  to the JSON file named by ``GPFLOW_TPU_TORCH_REFERENCE_STATE``, where one
  is named, with each launch's kernel, family and shape (N, M, D) by the
  test that made it (``_record_launches``).

One shim, and no other: ``np.asarray`` of a tensor reads it through
``.detach().cpu()``. The port's entry points return tensors that may carry
the autograd graph, which numpy cannot read (ROADMAP Queue 3, "the output
side of F3"); ``.cpu()`` is a no-op on the CPU and lets the same tests read
results made on the card.

Nothing happens at import: the hooks act only when pytest loads the module
as a plugin, so the tier-1 run, which collects this file as a test module,
keeps the JAX package under its own name.

The conformance files (``tests/test_torch_reference_<area>.py``) each run
their JAX test files once, in one such process or in a few side by side
(``run``), and make one case
of each JAX test node (``check``): the case passes where the JAX test passes
on the port, or where it fails as a row of ``DIFFERENCES`` says it must. The
table is strict: a listed test that passes, or fails with another error,
fails its case. The node ids are committed in
``tests/test_torch_reference_nodes.json``, which
``python -m tests.test_torch_reference_plugin`` writes anew from a
collection through the alias; each area checks its run against them.
``chip_smoke.py`` runs a subset on the card through ``command``.
"""
import importlib
import importlib.abc
import importlib.machinery
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest

ALIAS = "gpflow_tpu"
PORT = "gpflow_tpu_torch"
REPO = pathlib.Path(__file__).resolve().parent.parent
DEVICE_VARIABLE = "GPFLOW_TPU_TORCH_REFERENCE_DEVICE"
REPORT_VARIABLE = "GPFLOW_TPU_TORCH_REFERENCE_REPORT"
STATE_VARIABLE = "GPFLOW_TPU_TORCH_REFERENCE_STATE"
SHARD_VARIABLE = "GPFLOW_TPU_TORCH_REFERENCE_SHARD"
NODES_FILE = pathlib.Path(__file__).with_name("test_torch_reference_nodes.json")

# The JAX package's test files that import neither jax nor optax, but two.
JAX_TEST_DIRS = ("tests/gpflow_tpu", "tests/integration")
EXCLUDED_FILES = {
    "tests/integration/test_benchmark.py": "drives benchmark/, which the port does not port now (ROADMAP item 5)",
    "tests/gpflow_tpu/utilities/test_contract_coverage.py": (
        "counts decorators by path under gpflow_tpu/; tests/test_torch_contracts.py counts the port's"
    ),
}

# ROADMAP Queue 3's deviations that JAX tests meet, by the name each row cites.
DEVIATIONS = {
    "dtype getters": "config.default_float(), default_int() and Config's fields are torch dtypes",
    "parameters": "Module.parameters is torch's method; the JAX property is all_parameters",
    "serving platform": "serving artifacts name the torch platform of the model's device",
    "examples with jax": "a doc example that imports jax or optax drives the JAX package only",
}

_CONFIG = "tests/gpflow_tpu/test_config.py::"
_EXAMPLE = "tests/integration/test_examples.py::test_example_runs"
# node id -> (the deviation's name, a text the failure must contain)
DIFFERENCES = {
    **{_CONFIG + case: ("dtype getters", "assert torch.") for case in (
        "test_dtype_setting[default_float-set_default_float-float32-float64]",
        "test_dtype_setting[default_int-set_default_int-int64-int32]",
        "test_env_variables[float-float16-float16]",
        "test_env_variables[float-float32-float32]",
        "test_env_variables[int-int16-int16]",
        "test_env_variables[int-int64-int64]",
        "test_native_to_default_dtype[set_default_float-default_float-to_default_float-float32-3.14159]",
        "test_native_to_default_dtype[set_default_float-default_float-to_default_float-float64-value3]",
        "test_native_to_default_dtype[set_default_int-default_int-to_default_int-int32-3]",
        "test_native_to_default_dtype[set_default_int-default_int-to_default_int-int64-value1]",
    )},
    "tests/gpflow_tpu/utilities/test_traversal_depth.py::test_module_parameters_return_tuples_not_generators": (
        "parameters", "isinstance(params, tuple)"),
    "tests/gpflow_tpu/utilities/test_serving.py::test_metadata": ("serving platform", "assert 'tpu' in"),
    **{f"{_EXAMPLE}[{name}]": ("examples with jax", "") for name in (
        "classification.py", "convolutional.py", "external_mean_function.py", "gp_nn.py", "heteroskedastic.py",
        "kernel_design.py", "large_data.py", "mcmc.py", "mixture_density_network.py",
        "monitoring_and_checkpoints.py", "multiclass.py", "multioutput.py", "natgrad_classification.py",
        "ordinal_regression.py", "parameters.py", "saving_and_loading.py", "variational_fourier_features.py",
        "varying_noise.py",
    )},
}

_IMPORTS_JAX = re.compile(r"^\s*(import|from) (jax|optax)\b", re.M)


def jax_free_files():
    """The JAX package's test files that import neither jax nor optax, by
    the import test, relative to the repository's root."""
    return sorted(
        str(path.relative_to(REPO))
        for d in JAX_TEST_DIRS
        for path in (REPO / d).rglob("test_*.py")
        if not _IMPORTS_JAX.search(path.read_text())
    )


def command(paths):
    """The pytest command line that runs ``paths`` (files or node ids,
    relative to the repository's root) on the port through this plugin."""
    return [
        sys.executable, "-m", "pytest", *paths, "-q", "--noconftest",
        "-p", "tests.test_torch_reference_plugin",
        "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
    ]


# One thread of torch's and numpy's pools for the process: it runs beside
# the suite's other workers, and the JAX tests' arrays are small.
SERIAL = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}


def run(paths, workdir, timeout, shards=1):
    """Runs ``paths`` on the port under ``workdir`` (the temporary
    directories, logs and reports go there) in ``shards`` pytest processes
    side by side, the ``i``-th taking the ``i``-th of every ``shards``
    collected tests, which together may take ``timeout`` seconds (each
    area's ``LIMIT``: about 3x its time in the tier-1 run, so that a hang
    fails the area's cases, not the suite's run); returns the outcomes of
    all of them by node id."""
    workdir = pathlib.Path(workdir)
    processes = []
    for i in range(shards):
        report, log = workdir / f"outcomes{i}.json", workdir / f"log{i}.txt"
        env = {**os.environ, **SERIAL, REPORT_VARIABLE: str(report), SHARD_VARIABLE: f"{i}/{shards}"}
        with open(log, "w") as out:
            process = subprocess.Popen([*command(paths), f"--basetemp={workdir / f'tmp{i}'}"], cwd=REPO, env=env,
                                       stdout=out, stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)
        processes.append((process, report, log))
    deadline = time.monotonic() + timeout
    outcomes = {}
    try:
        for process, report, log in processes:
            process.wait(timeout=max(deadline - time.monotonic(), 0.0))
            tail = "\n".join(log.read_text().splitlines()[-30:])
            assert report.exists(), f"the run wrote no report (exit code {process.returncode}):\n{tail}"
            outcomes.update(json.loads(report.read_text()))
    finally:
        for process, _, _ in processes:
            if process.poll() is None:
                process.kill()
                process.wait()
    return outcomes


def committed_nodes(paths):
    """The committed node ids of the JAX test files ``paths``, in order."""
    nodes = json.loads(NODES_FILE.read_text())
    return [node for path in paths for node in nodes[path]]


def mismatch(node, outcomes):
    """Why a JAX test's outcome on the port breaks ``DIFFERENCES``, or None
    where it keeps it (a test that skips itself keeps it)."""
    if node not in outcomes:
        return f"{node} did not run on the port"
    outcome, message = outcomes[node]["outcome"], outcomes[node]["message"]
    row = DIFFERENCES.get(node)
    if row is None:
        return None if outcome in ("passed", "skipped") else f"{node} fails on the port:\n{message}"
    deviation, text = row
    if outcome != "failed":
        return f"{node} {outcome} on the port: take its row ({deviation}) out of the table"
    if text not in message:
        return f"{node} fails otherwise than its row ({deviation}) says:\n{message}"
    return None


def check(node, outcomes):
    """One JAX test's case: its outcome on the port, held to ``DIFFERENCES``."""
    reason = mismatch(node, outcomes)
    assert reason is None, reason
    if outcomes[node]["outcome"] == "skipped":
        pytest.skip(f"the JAX test skips: {outcomes[node]['message']}")


class _PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds ``gpflow_tpu[.<sub>]`` and loads it as ``gpflow_tpu_torch[.<sub>]``:
    the port's own module object, with its own name and spec, is put in
    ``sys.modules`` under the alias, which the import system reads back."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname == ALIAS or fullname.startswith(ALIAS + "."):
            return importlib.machinery.ModuleSpec(fullname, self, is_package=True)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        name = module.__name__
        sys.modules[name] = importlib.import_module(PORT + name[len(ALIAS):])


def pytest_configure(config):
    assert ALIAS not in sys.modules, "the JAX package was imported before the alias"
    sys.meta_path.insert(0, _PortAlias())
    import torch

    import gpflow_tpu
    import gpflow_tpu_torch

    assert sys.modules[ALIAS] is gpflow_tpu_torch and gpflow_tpu is gpflow_tpu_torch
    gpflow_tpu_torch.config.set_default_device(os.environ.get(DEVICE_VARIABLE, "cpu"))
    gpflow_tpu_torch.utilities.set_enable_check_shapes(True)
    as_array = torch.Tensor.__array__
    torch.Tensor.__array__ = lambda t, *a, **k: as_array(t.detach().cpu(), *a, **k)
    config._reference_outcomes = {}
    config._reference_collected = []
    config._reference_launches = _record_launches() if os.environ.get(STATE_VARIABLE) else {}


# The node id of the test that runs, for ``_record_launches``.
_RUNNING = [None]


def _record_launches():
    """Wraps the kernels' CUDA wrappers so that each launch is recorded as
    [kernel, family, N, M, D] under the running test's node id; returns the
    records."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    records = {}
    for kernel, name in (("K1", "stationary_forward_cuda"), ("K2", "stationary_wgrad_cuda")):
        def recording(family, Xs, Zs, *args, _launch=getattr(pd, name), _kernel=kernel):
            before = pd.launch_counts[_kernel]
            out = _launch(family, Xs, Zs, *args)
            if pd.launch_counts[_kernel] > before:
                records.setdefault(_RUNNING[0], []).append([_kernel, family, Xs.shape[0], Zs.shape[0], Xs.shape[1]])
            return out

        setattr(pd, name, recording)
    return records


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _RUNNING[0] = item.nodeid
    yield
    _RUNNING[0] = None


def pytest_collection_modifyitems(config, items):
    slow = [item for item in items if item.get_closest_marker("slow")]
    if slow:
        config.hook.pytest_deselected(items=slow)
        items[:] = [item for item in items if not item.get_closest_marker("slow")]
    shard = os.environ.get(SHARD_VARIABLE)
    if shard:
        index, count = (int(n) for n in shard.split("/"))
        config.hook.pytest_deselected(items=[item for i, item in enumerate(items) if i % count != index])
        items[:] = items[index::count]
    config._reference_collected = [item.nodeid for item in items]


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    outcomes = item.config._reference_outcomes
    entry = outcomes.setdefault(item.nodeid, {"outcome": "passed", "message": ""})
    if report.failed:
        entry["outcome"] = "failed"
        entry["message"] += f"[{report.when}] {report.longreprtext[-4000:]}\n"
    elif report.skipped and hasattr(report, "wasxfail"):
        entry["outcome"] = "xfailed"
        entry["message"] = report.wasxfail
    elif report.skipped and entry["outcome"] == "passed":
        entry["outcome"] = "skipped"
        entry["message"] = str(report.longrepr[-1]) if isinstance(report.longrepr, tuple) else report.longreprtext


def pytest_unconfigure(config):
    path = os.environ.get(REPORT_VARIABLE)
    if path and hasattr(config, "_reference_outcomes"):
        written = config._reference_collected if config.option.collectonly else config._reference_outcomes
        pathlib.Path(path).write_text(json.dumps(written, indent=0, sort_keys=True))
    path = os.environ.get(STATE_VARIABLE)
    if path:
        from gpflow_tpu_torch.config import default_device
        from gpflow_tpu_torch.ops.pallas_distance import launch_counts

        state = {"default_device": str(default_device()), "launch_counts": dict(launch_counts),
                 "launches_by_test": config._reference_launches}
        pathlib.Path(path).write_text(json.dumps(state))


@pytest.fixture
def rng() -> np.random.RandomState:
    return np.random.RandomState(0)


# --- the harness's own checks (collected in the tier-1 run) --------------------

AREAS = ("conditionals", "kernels", "models", "posteriors", "surface", "tools", "uncertain")


def test_every_jax_free_file_runs_in_one_area_or_is_excluded():
    areas = [importlib.import_module(f"tests.test_torch_reference_{a}").FILES for a in AREAS]
    run = [f for files in areas for f in files]
    assert len(run) == len(set(run))
    assert sorted(run + list(EXCLUDED_FILES)) == jax_free_files()
    assert sorted(json.loads(NODES_FILE.read_text())) == sorted(run)


def test_each_difference_names_a_deviation_and_a_committed_node():
    nodes = set(committed_nodes(json.loads(NODES_FILE.read_text())))
    for node, (deviation, _) in DIFFERENCES.items():
        assert deviation in DEVIATIONS, node
        assert node in nodes, node


def test_the_example_rows_are_the_examples_that_import_jax():
    examples = REPO / "doc" / "examples"
    with_jax = {p.name for p in examples.glob("*.py") if _IMPORTS_JAX.search(p.read_text())}
    rows = {node[len(_EXAMPLE) + 1:-1] for node in DIFFERENCES if node.startswith(_EXAMPLE)}
    assert rows == with_jax


def test_the_table_is_strict():
    listed, (_, text) = next(iter(DIFFERENCES.items()))
    other = "tests/gpflow_tpu/test_logdensities.py::test_gaussian"
    entry = lambda outcome, message="": {"outcome": outcome, "message": message}  # noqa: E731
    assert mismatch(listed, {listed: entry("failed", f"E {text} ...")}) is None
    assert "take its row" in mismatch(listed, {listed: entry("passed")})
    assert "otherwise" in mismatch(listed, {listed: entry("failed", "E TypeError")})
    assert mismatch(other, {other: entry("passed")}) is None
    assert "fails on the port" in mismatch(other, {other: entry("failed", "E TypeError")})
    assert "did not run" in mismatch(other, {})


if __name__ == "__main__":
    # Writes the node ids of every JAX test file that the conformance files
    # run, as a collection through the alias gives them.
    import tempfile

    files = [f for f in jax_free_files() if f not in EXCLUDED_FILES]
    with tempfile.TemporaryDirectory() as tmp:
        report = pathlib.Path(tmp) / "collected.json"
        subprocess.run([*command(files), "--collect-only"], cwd=REPO, check=True, stdout=subprocess.DEVNULL,
                       env={**os.environ, REPORT_VARIABLE: str(report)})
        collected = json.loads(report.read_text())
    NODES_FILE.write_text(json.dumps({f: [n for n in collected if n.split("::")[0] == f] for f in files}, indent=1) + "\n")

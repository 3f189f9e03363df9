"""The map of the JAX package's test files that import jax or optax onto the
port: one row per ``def test_*`` of each file, found by ``ast`` without
importing it, in ``tests/test_torch_translated_map.json``. A row's status is

* ``translated``: a test of the same name in the file's translation,
  ``tests/test_torch_translated_<stem>.py``;
* ``deviation:<name>``: translated too, but marked ``deviation(<name>)``
  (a strict xfail), where ``<name>`` is a deviation of ROADMAP Queue 3 listed
  in ``test_torch_translated_support.DEVIATIONS``;
* ``queued``: not translated yet; only in the files of ``QUEUED``, which
  is empty since every file is translated.

A translated test marked ``slow`` (``slow_tests``) is deselected by the
plugin, as tier-1 deselects it, and phase 28 does not run it.

A row may carry a ``note`` naming the port's counterpart of a private JAX
name that its translation uses. ``python -m tests.test_torch_translated_map``
writes the map anew from the files and the translations, keeping the notes.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from . import test_torch_translated_support as support
from .test_torch_reference_plugin import _IMPORTS_JAX, JAX_TEST_DIRS, REPO, SERIAL
from .test_torch_environment import one_thread  # noqa: F401

MAP_FILE = pathlib.Path(__file__).with_name("test_torch_translated_map.json")

# The files left for a later slice, in ROADMAP item R1's order: none since
# every file of item R1 is translated.
QUEUED = []

# A JAX file's imports that a translation must not keep.
_IMPORTS_REFERENCE = re.compile(r"^\s*(import|from) (jax|optax|gpflow_tpu)\b", re.M)


def jax_files():
    """The JAX package's test files that import jax or optax, relative to
    the repository's root."""
    return sorted(
        str(path.relative_to(REPO))
        for d in JAX_TEST_DIRS
        for path in (REPO / d).rglob("test_*.py")
        if _IMPORTS_JAX.search(path.read_text())
    )


def translation(jax_file):
    """The translated file of ``jax_file``, relative to the root."""
    return f"tests/test_torch_translated_{pathlib.Path(jax_file).stem[len('test_'):]}.py"


def jax_test_names(path):
    """The ``def test_*`` names of a file, in order, by ``ast``."""
    tree = ast.parse((REPO / path).read_text())
    return [
        node.name
        for node in ast.walk(tree)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test_")
    ]


def _is_slow_mark(node):
    return isinstance(node, ast.Attribute) and node.attr == "slow"


def slow_tests(path):
    """The ``def test_*`` names of a file that are marked ``slow``, by the
    module's ``pytestmark`` or their own decorator; tier-1 and phase 28
    deselect them."""
    tree = ast.parse((REPO / path).read_text())
    whole = any(isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "pytestmark" for t in node.targets)
                and _is_slow_mark(node.value) for node in tree.body)
    return {name for name in jax_test_names(path)} if whole else {
        node.name for node in ast.walk(tree)
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")
        and any(_is_slow_mark(d) for d in node.decorator_list)
    }


def deviation_marks(path):
    """The deviation each test of a translated file is marked with, by name."""
    marks = {}
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            for d in node.decorator_list:
                if isinstance(d, ast.Call) and getattr(d.func, "id", None) == "deviation":
                    marks[node.name] = d.args[0].value
    return marks


def read_map():
    return json.loads(MAP_FILE.read_text())


def translated_files():
    return sorted({translation(row["file"]) for row in read_map() if row["status"] != "queued"})


# --- the checks ------------------------------------------------------------------


def test_every_function_has_exactly_one_row():
    rows = read_map()
    keys = [(row["file"], row["test"]) for row in rows]
    assert len(keys) == len(set(keys))
    expected = [(f, name) for f in jax_files() for name in dict.fromkeys(jax_test_names(f))]
    assert sorted(keys) == sorted(expected)


def test_queued_only_in_the_queued_files():
    rows = read_map()
    queued = {row["file"] for row in rows if row["status"] == "queued"}
    assert queued <= set(QUEUED)
    assert set(QUEUED) <= set(jax_files())
    for row in rows:
        assert row["status"] in ("translated", "queued") or row["status"].startswith("deviation:"), row


def test_each_row_matches_its_translation():
    rows = read_map()
    names, marks = {}, {}
    for path in translated_files():
        assert (REPO / path).exists(), path
        names[path], marks[path] = jax_test_names(path), deviation_marks(path)
    for row in rows:
        if row["status"] == "queued":
            continue
        path = translation(row["file"])
        assert row["test"] in names[path], row
        mark = marks[path].get(row["test"])
        if row["status"] == "translated":
            assert mark is None, row
        else:
            assert mark == row["status"][len("deviation:"):], row
            assert mark in support.DEVIATIONS, row


def test_every_jax_file_is_translated():
    """Every JAX test file that imports jax or optax has its translation,
    and no row of the map is queued."""
    rows = read_map()
    assert not QUEUED
    assert not [row for row in rows if row["status"] == "queued"]
    for f in jax_files():
        assert (REPO / translation(f)).exists(), f


def test_each_deviation_is_in_the_roadmap():
    text = (REPO / "ROADMAP.md").read_text()
    queue3 = text[text.index("### Queue 3"):text.index("## Recent")].lower()
    used = {row["status"][len("deviation:"):] for row in read_map() if row["status"].startswith("deviation:")}
    for name in used:
        assert name.lower() in queue3, name


@pytest.mark.parametrize("path", translated_files())
def test_no_translation_imports_the_reference(path):
    text = (REPO / path).read_text()
    assert not _IMPORTS_REFERENCE.search(text), path


def test_every_translated_row_is_collected(tmp_path):
    report = tmp_path / "collected.json"
    done = subprocess.run(
        [sys.executable, "-m", "pytest", *translated_files(), "--collect-only", "-q", "--noconftest",
         "-p", "tests.test_torch_reference_plugin", "-p", "no:cacheprovider", "-p", "no:randomly",
         "-p", "no:xdist"],
        # the collection took 17-33 s in the tier-1 run: a hang fails this case in about 3x that
        cwd=REPO, capture_output=True, text=True, timeout=100, stdin=subprocess.DEVNULL,
        env={**os.environ, **SERIAL, "GPFLOW_TPU_TORCH_REFERENCE_REPORT": str(report)},
    )
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    collected = {node.split("[")[0] for node in json.loads(report.read_text())}
    slow = {(path, name) for path in translated_files() for name in slow_tests(path)}
    for row in read_map():
        path = translation(row["file"])
        if (path, row["test"]) in slow:
            assert f"{path}::{row['test']}" not in collected, row  # deselected, as tier-1 deselects it
        elif row["status"] != "queued":
            assert f"{path}::{row['test']}" in collected, row


if __name__ == "__main__":
    # Writes the map anew: a JAX file's tests are translated where its
    # translation exists, else queued; the deviation marks and the notes of
    # the committed map are kept.
    notes = {(r["file"], r["test"]): r["note"] for r in read_map() if "note" in r} if MAP_FILE.exists() else {}
    rows = []
    for f in jax_files():
        path = translation(f)
        present = (REPO / path).exists()
        marks = deviation_marks(path) if present else {}
        for name in dict.fromkeys(jax_test_names(f)):
            status = ("deviation:" + marks[name] if name in marks else "translated") if present else "queued"
            row = {"file": f, "test": name, "status": status}
            if (f, name) in notes:
                row["note"] = notes[(f, name)]
            rows.append(row)
    MAP_FILE.write_text(json.dumps(rows, indent=1) + "\n")

"""Where the tier-1 run's time goes, file by file, from its junit XML.

Loaded as a plugin (``-p tests.test_torch_junit_timing``) beside the tier-1
command's ``--junitxml``, it writes three properties into each test case:
the xdist worker that ran it, the wall-clock second it started and the
seconds of its setup (module fixtures: the rank groups, the conformance
processes, the serving exports). Run as a module on that XML, it prints one
line a file: the tests, the passes, the summed seconds (setup included), the
setup seconds, the worker and the file's start and end on the run's clock,
the costliest first; then each worker's end::

    python -m tests.test_torch_junit_timing /tmp/_t1.xml [FILTER]

Without the plugin the XML holds no worker and no start, and the lines leave
them out. As a test module it holds no test; pytest reads hooks from plugins
only, so the tier-1 run's collection of this file changes nothing.
"""
import collections
import os
import sys
import time
import xml.etree.ElementTree as ET

import pytest


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    item.user_properties.append(("worker", os.environ.get("PYTEST_XDIST_WORKER", "main")))
    item.user_properties.append(("t0", f"{time.time():.3f}"))
    yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    t0 = time.perf_counter()
    yield
    item.user_properties.append(("setup", f"{time.perf_counter() - t0:.3f}"))


def per_file(path):
    """{file: its tests, passes, summed and setup seconds, workers, start
    and end}, the starts and ends in seconds from the run's first test."""
    files = collections.defaultdict(lambda: {"tests": 0, "passed": 0, "seconds": 0.0, "setup": 0.0,
                                             "workers": set(), "start": None, "end": None})
    first = None
    cases = list(ET.parse(path).iter("testcase"))
    for case in cases:
        props = {p.get("name"): p.get("value") for p in case.iter("property")}
        if "t0" in props:
            first = min(first, float(props["t0"])) if first is not None else float(props["t0"])
    for case in cases:
        name = "/".join(part for part in case.get("classname", "").split(".") if not part[:1].isupper()) + ".py"
        props = {p.get("name"): p.get("value") for p in case.iter("property")}
        entry, seconds = files[name], float(case.get("time", 0))
        entry["tests"] += 1
        entry["passed"] += not any(c.tag in ("failure", "error", "skipped") for c in case)
        entry["seconds"] += seconds
        entry["setup"] += float(props.get("setup", 0))
        if "worker" in props:
            entry["workers"].add(props["worker"])
            start = float(props["t0"]) - first
            entry["start"] = start if entry["start"] is None else min(entry["start"], start)
            entry["end"] = max(entry["end"] or 0.0, start + seconds)
    return dict(files)


def main(path, only=""):
    files = per_file(path)
    ends = collections.defaultdict(float)
    for name, e in sorted(files.items(), key=lambda kv: -kv[1]["seconds"]):
        for worker in e["workers"]:
            ends[worker] = max(ends[worker], e["end"])
        if only in name:
            where = (f" {','.join(sorted(e['workers']))} {e['start']:7.1f}-{e['end']:7.1f}"
                     if e["workers"] else "")
            print(f"{name:62s} {e['tests']:5d} {e['passed']:5d} {e['seconds']:8.1f} {e['setup']:7.1f}{where}")
    if ends:
        print("worker ends:", {w: round(t, 1) for w, t in sorted(ends.items())})


if __name__ == "__main__":
    main(*sys.argv[1:])

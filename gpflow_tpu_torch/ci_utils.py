"""Helpers for runs under continuous integration (counterpart of
``gpflow_tpu/ci_utils.py``)."""
from __future__ import annotations

import os
from typing import Any, Iterable, Type

__all__ = ["is_continuous_integration", "reduce_in_tests", "subclasses"]


def is_continuous_integration() -> bool:
    """True when running under CI: ``CI`` is set and ``DOCS`` is not."""
    if "DOCS" in os.environ:
        return False
    return "CI" in os.environ


def reduce_in_tests(n: int, test_n: int = 2) -> int:
    """``test_n`` under CI, else ``n``: caps expensive loop counts there."""
    return test_n if is_continuous_integration() else n


def subclasses(cls: Type[Any]) -> Iterable[Type[Any]]:
    """Every subclass of ``cls``, direct or not, the deepest first."""
    for subclass in cls.__subclasses__():
        yield from subclasses(subclass)
        yield subclass

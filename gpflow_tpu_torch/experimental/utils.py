"""Helpers for experimental code (counterpart of
``gpflow_tpu/experimental/utils.py``)."""
from __future__ import annotations

from functools import wraps
from typing import Any, Callable, TypeVar, cast
from warnings import warn

__all__ = ["experimental"]

C = TypeVar("C", bound=Callable[..., Any])


def experimental(func: C) -> C:
    """Marks ``func`` as experimental: its first call warns, later ones do not."""
    has_warned = False

    @wraps(func)
    def wrap_experimental(*args: Any, **kwargs: Any) -> Any:
        nonlocal has_warned
        if not has_warned:
            name = f"{func.__module__}.{func.__qualname__}"
            warn(
                f"You're calling {name} which is considered *experimental*."
                " Expect: breaking changes, poor documentation, and bugs."
            )
            has_warned = True
        return func(*args, **kwargs)

    return cast(C, wrap_experimental)

"""The bijector helpers under ``utilities`` (counterpart of
``gpflow_tpu/utilities/bijectors.py``): ``positive``, ``triangular`` and
``triangular_size`` of ``gpflow_tpu_torch.bijectors``.

They resolve lazily (module ``__getattr__``), as in the JAX package: the
package's ``bijectors`` imports ``utilities.shapes`` for its contract, which
initialises this package, so an eager ``from ..bijectors import ...`` here
would re-enter the partially initialised module.
"""
from typing import Any

__all__ = [
    "positive",
    "triangular",
    "triangular_size",
]


def __getattr__(name: str) -> Any:
    if name in __all__:
        from .. import bijectors as _bijectors

        return getattr(_bijectors, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__() -> list:
    return sorted(__all__)

"""Experimental code: expect breaking changes, poor documentation and bugs
(counterpart of ``gpflow_tpu/experimental/__init__.py``)."""
from . import utils

__all__ = ["utils"]

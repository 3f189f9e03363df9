"""Conditional dispatchers (counterpart of ``gpflow_tpu/conditionals/dispatch.py``)."""
from ..utilities.multipledispatch import Dispatcher

__all__ = ["conditional", "sample_conditional"]

conditional = Dispatcher("conditional")
sample_conditional = Dispatcher("sample_conditional")

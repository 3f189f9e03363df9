"""Kuu/Kuf dispatchers (counterpart of ``gpflow_tpu/covariances/dispatch.py``)."""
from ..utilities.multipledispatch import Dispatcher

__all__ = ["Kuf", "Kuu"]

Kuu = Dispatcher("Kuu")
Kuf = Dispatcher("Kuf")

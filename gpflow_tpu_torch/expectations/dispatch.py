"""The expectation dispatchers (counterpart of ``gpflow_tpu/expectations/dispatch.py``).
A miss raises ``NotImplementedError``, on which ``expectation`` falls back to
quadrature."""
from ..utilities import Dispatcher

__all__ = ["expectation", "quadrature_expectation", "variational_expectation"]

expectation = Dispatcher("expectation")
quadrature_expectation = Dispatcher("quadrature_expectation")
# declared and never registered, as in the JAX package
variational_expectation = Dispatcher("variational_expectation")

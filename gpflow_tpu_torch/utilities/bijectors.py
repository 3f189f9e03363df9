"""The bijector helpers under ``utilities`` (counterpart of
``gpflow_tpu/utilities/bijectors.py``): ``positive``, ``triangular`` and
``triangular_size`` of ``gpflow_tpu_torch.bijectors``. The port's
bijectors import nothing of ``utilities``, so these are plain re-exports
where the JAX package resolves them lazily."""
from ..bijectors import positive, triangular, triangular_size

__all__ = [
    "positive",
    "triangular",
    "triangular_size",
]

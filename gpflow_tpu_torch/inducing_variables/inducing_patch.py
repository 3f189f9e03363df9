"""Inducing patches for convolutional kernels (counterpart of
``gpflow_tpu/inducing_variables/inducing_patch.py``)."""
from .inducing_variables import InducingPoints

__all__ = ["InducingPatches"]


class InducingPatches(InducingPoints):
    """Inducing variables in patch space; Z: [M, patch_len]."""

from . import kufs, kuus  # noqa: F401  (registrations)
from .dispatch import Kuf, Kuu

__all__ = ["Kuf", "Kuu"]

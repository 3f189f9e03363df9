from . import kufs, kuus
from . import multioutput
from .dispatch import Kuf, Kuu

__all__ = ["Kuf", "Kuu", "kufs", "kuus", "multioutput"]

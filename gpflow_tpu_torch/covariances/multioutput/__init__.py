from . import kufs, kuus

__all__ = ["kufs", "kuus"]

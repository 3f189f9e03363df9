from . import conditionals

__all__ = ["conditionals"]

from . import conditionals, sample_conditionals

__all__ = ["conditionals", "sample_conditionals"]

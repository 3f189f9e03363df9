from .inducing_variables import InducingPoints, InducingPointsBase, InducingVariables

__all__ = ["InducingPoints", "InducingPointsBase", "InducingVariables"]

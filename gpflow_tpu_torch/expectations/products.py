"""Expectations of Product kernels over a DiagonalGaussian, whose terms act
on separate dimensions (counterpart of ``gpflow_tpu/expectations/products.py``)."""
from __future__ import annotations

from functools import reduce
from typing import Type

import torch

from .. import kernels
from ..inducing_variables import InducingPoints
from ..probability_distributions import DiagonalGaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


def _require_separate_dimensions(kernel: kernels.Product) -> None:
    if not kernel.on_separate_dimensions:
        raise NotImplementedError("Product currently needs to be defined on separate dimensions.")


@dispatch.expectation.register(DiagonalGaussian, kernels.Product, NoneType, NoneType, NoneType)
@check_shapes("p: [N, D]", "return: [N]")
def _expectation_diagonal_product(p, kernel, _, __, ___, nghp=None):
    _require_separate_dimensions(kernel)
    return reduce(torch.multiply, [expectation(p, k, nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(DiagonalGaussian, kernels.Product, InducingPoints, NoneType, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M]")
def _expectation_diagonal_product_inducingpoints(p, kernel, inducing_variable, __, ___, nghp=None):
    _require_separate_dimensions(kernel)
    return reduce(torch.multiply, [expectation(p, (k, inducing_variable), nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(
    DiagonalGaussian, kernels.Product, InducingPoints, kernels.Product, InducingPoints
)
@check_shapes("p: [N, D]", "feat1: [M, D, P]", "feat2: [M, D, P]", "return: [N, M, M]")
def _expectation_diagonal_product_inducingpoints__product_inducingpoints(p, kern1, feat1, kern2, feat2, nghp=None):
    if feat1 is not feat2:
        raise NotImplementedError("Different inducing variables are not supported.")
    if kern1 is not kern2:
        raise NotImplementedError("Calculating the expectation over two different Product kernels is not supported.")
    _require_separate_dimensions(kern1)
    return reduce(torch.multiply, [expectation(p, (k, feat1), (k, feat1), nghp=nghp) for k in kern1.kernels])

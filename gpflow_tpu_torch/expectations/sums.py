"""Expectations of Sum kernels, term by term (counterpart of
``gpflow_tpu/expectations/sums.py``)."""
from __future__ import annotations

import itertools
from functools import reduce
from typing import Type

import torch

from .. import functions as mfn
from .. import kernels
from ..inducing_variables import InducingPoints
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


@dispatch.expectation.register(Gaussian, kernels.Sum, NoneType, NoneType, NoneType)
@check_shapes("p: [N, D]", "return: [N]")
def _expectation_gaussian_sum(p, kernel, _, __, ___, nghp=None):
    return reduce(torch.add, [expectation(p, k, nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(Gaussian, kernels.Sum, InducingPoints, NoneType, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M]")
def _expectation_gaussian_sum_inducingpoints(p, kernel, inducing_variable, _, __, nghp=None):
    return reduce(torch.add, [expectation(p, (k, inducing_variable), nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(
    Gaussian, (mfn.Linear, mfn.Identity, mfn.Constant), NoneType, kernels.Sum, InducingPoints
)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, Q, M]")
def _expectation_gaussian_linear__sum_inducingpoints(p, mean, _, kernel, inducing_variable, nghp=None):
    return reduce(torch.add, [expectation(p, mean, (k, inducing_variable), nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(MarkovGaussian, mfn.Identity, NoneType, kernels.Sum, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, D, M]")
def _expectation_markov__sum_inducingpoints(p, mean, _, kernel, inducing_variable, nghp=None):
    return reduce(torch.add, [expectation(p, mean, (k, inducing_variable), nghp=nghp) for k in kernel.kernels])


@dispatch.expectation.register(
    (Gaussian, DiagonalGaussian), kernels.Sum, InducingPoints, kernels.Sum, InducingPoints
)
@check_shapes("p: [N, D]", "feat1: [M1, D, P]", "feat2: [M2, D, P]", "return: [N, M1, M2]")
def _expectation_gaussian_sum_inducingpoints__sum_inducingpoints(p, kern1, feat1, kern2, feat2, nghp=None):
    """psi2 of Sum kernels from the pairwise cross-expectations; for one
    kernel with itself each unordered pair once, with its transpose."""
    crossexps = []
    if kern1 is kern2 and feat1 is feat2:
        for i, k1 in enumerate(kern1.kernels):
            crossexps.append(expectation(p, (k1, feat1), (k1, feat1), nghp=nghp))
            for k2 in kern1.kernels[:i]:
                eKK = expectation(p, (k1, feat1), (k2, feat2), nghp=nghp)
                crossexps.append(eKK + eKK.mT)
    else:
        for k1, k2 in itertools.product(kern1.kernels, kern2.kernels):
            crossexps.append(expectation(p, (k1, feat1), (k2, feat2), nghp=nghp))
    return reduce(torch.add, crossexps)

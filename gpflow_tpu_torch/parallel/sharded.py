"""Row-split data for internal-data models and row-split prediction
(counterpart of ``gpflow_tpu/parallel/sharded.py``).

``shard_internal_data`` keeps on each rank its block of the training rows.
The models' reductions over rows are then local partial sums and one
differentiable all-reduce over the data axis (``_sharding``), and every
rank holds the same objective and the same gradients:

* SGPR, GPRFITC, CGLB: Kuf [M, N] is built in column blocks; A A^T, A err,
  sum err^2 and the trace terms are summed over the ranks; the [M, M]
  Choleskys are replicated. CGLB's CG vectors are split like the rows: its
  dot products are summed, and each K-matvec builds this rank's columns
  K(X, x_block) against the gathered vector.
* The Bayesian GPLVM: the psi statistics of this rank's rows, summed.
* GPR (and the GPLVM) and VGP: each rank builds its rows K(X_block, X); the
  blocks are gathered before the [N, N] Cholesky, which is replicated.
* Prediction: the test points are row-parallel at any scale.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._compile import jit
from .._sharding import Blocks, ReadHook
from ..base import Module, Parameter, input_to_tensor
from .mesh import DEFAULT_AXIS, _holds_this_rank, make_mesh

__all__ = ["shard_internal_data", "sharded_predict_f"]


def _splittable() -> Tuple[type, ...]:
    from ..models import GPR, VGP, BayesianGPLVM, SGPRBase_deprecated, VGPOpperArchambeau
    from ..models.vgp import VGP_deprecated

    return (GPR, VGP, VGP_deprecated, VGPOpperArchambeau, SGPRBase_deprecated, BayesianGPLVM)


def shard_internal_data(
    model: Module, mesh: Optional[DeviceMesh] = None, axis_name: str = DEFAULT_AXIS
) -> Module:
    """Keeps on each rank of the mesh's ``axis_name`` axis its block of an
    internal-data model's training rows, in place; returns the model.

    Every rank calls it, and then every entry point of the model, alike
    (SPMD). A Parameter in the data (the GPLVM's latent X) stays whole on
    every rank. The number of rows must divide evenly over the axis, as
    the JAX package's sharding requires. Each read of a Parameter of the
    model then carries the gradient rule of ``_sharding``. On a rank that
    the mesh leaves out the model keeps its rows (``_holds_this_rank``)."""
    data = getattr(model, "data", None)
    if data is None:
        raise ValueError(
            "shard_internal_data expects an internal-data model with a "
            "`.data` attribute (GPR/SGPR/VGP/CGLB/GPLVM...); for external-"
            "data (minibatch) models use DataParallelTrainer instead."
        )
    if not isinstance(model, _splittable()):
        raise NotImplementedError(f"shard_internal_data: {type(model).__name__}'s objective has no row reductions")
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    if not _holds_this_rank(mesh):
        return model
    tensors = [data] if isinstance(data, torch.Tensor) else [a for a in data if not isinstance(a, Parameter)]
    if tensors[0].device.type != mesh.device_type:
        raise ValueError(f"the model's data is on {tensors[0].device.type}, the mesh is over {mesh.device_type}")
    rows = Blocks.over(mesh.get_group(axis_name), tensors[0].shape[0], "the number of data rows")

    def place(a: Any) -> Any:
        # a trainable Parameter in the data stays whole: the optimizer keeps it
        return a if isinstance(a, Parameter) else rows.local(a).clone()

    if isinstance(data, torch.Tensor):
        model.data = place(data)
    elif isinstance(data, tuple):
        model.data = tuple(place(a) for a in data)
    else:  # a module that registers (X, Y) as a Parameter and a buffer: the GPLVM's
        for name, buffer in list(data.named_buffers(recurse=False)):
            data.register_buffer(name, place(buffer))
    model._row_blocks = rows
    hook = ReadHook((rows.group,), rows.size)
    for p in model.all_parameters:
        p._read_hook = hook
    return model


# one traced prediction per keyword set, over the model (or posterior) as an input
_PREDICT_JITS: Dict[Tuple[Any, ...], jit] = {}


def sharded_predict_f(
    model: Any,
    Xnew: Any,
    mesh: Optional[DeviceMesh] = None,
    axis_name: str = DEFAULT_AXIS,
    **predict_kwargs: Any,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``model.predict_f`` with the test points split by rows over the
    mesh's ``axis_name`` axis: each rank predicts its block of Xnew, and
    every rank returns the gathered (mean, var). Accepts a model or a
    posterior (anything with ``predict_f(Xnew, **kwargs)``). The number of
    points must divide evenly over the axis. A full covariance couples the
    rows: with ``full_cov`` or ``full_output_cov`` every rank predicts all
    of them, as does a rank that the mesh leaves out.

    The prediction is traced (``_compile.jit``) once per keyword set and
    input signature, and takes the model as an input: repeated calls (a
    serving loop) replay one trace, for any model of the same structure, at
    its current parameter values."""
    mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
    Xnew = input_to_tensor(model, Xnew)
    key = tuple(sorted(predict_kwargs.items()))
    fn = _PREDICT_JITS.get(key)
    if fn is None:
        kwargs = dict(predict_kwargs)

        def _predict(m: Any, x: torch.Tensor, rows: Optional[Blocks]) -> Tuple[torch.Tensor, torch.Tensor]:
            if rows is None:
                return m.predict_f(x, **kwargs)
            mean, var = m.predict_f(rows.local(x), **kwargs)
            return rows.gather(mean), rows.gather(var)

        fn = _PREDICT_JITS[key] = jit(_predict)
    whole = predict_kwargs.get("full_cov") or predict_kwargs.get("full_output_cov") or not _holds_this_rank(mesh)
    rows = None if whole else Blocks.over(mesh.get_group(axis_name), Xnew.shape[0], "the number of points")
    return fn(model, Xnew, rows)

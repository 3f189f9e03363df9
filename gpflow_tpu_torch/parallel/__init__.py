"""Scale-out over ``torch.distributed`` (counterpart of
``gpflow_tpu/parallel/``): a ``DeviceMesh`` over the ranks of the default
process group (``make_mesh``), the data's rows split over its data axis
(``shard_internal_data``, ``sharded_predict_f``, ``DataParallelTrainer``)
and, for multioutput models, the latent GPs over a second axis
(``DataParallelTrainer``'s ``latent_axis``). Every rank runs the same
program; the collectives are gloo's on the CPU and NCCL's on CUDA devices.
"""
from .mesh import make_hybrid_mesh, make_mesh, replicated, shard_batch
from .sharded import shard_internal_data, sharded_predict_f
from .trainer import DataParallelTrainer, adam

__all__ = [
    "DataParallelTrainer",
    "adam",
    "make_hybrid_mesh",
    "make_mesh",
    "replicated",
    "shard_batch",
    "shard_internal_data",
    "sharded_predict_f",
]

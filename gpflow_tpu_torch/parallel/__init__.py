"""Training drivers (counterpart of ``gpflow_tpu/parallel/``; the
single-device trainer so far, the mesh waits for more than one GPU)."""
from .trainer import DataParallelTrainer, adam

__all__ = ["DataParallelTrainer", "adam"]

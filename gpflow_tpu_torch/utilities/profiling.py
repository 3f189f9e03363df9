"""Profiling helpers (counterpart of ``gpflow_tpu/utilities/profiling.py``).

``profile`` traces the block with ``torch.profiler`` (host and, where a card
is present, CUDA activity) and writes a Chrome trace into ``log_dir``, which
TensorBoard's profiler plugin and Perfetto read; ``annotate`` names a region
so that it shows in the trace's timeline.

Example::

    with profile("/tmp/gp-trace"):
        for step in range(100):
            with annotate("train_step"):
                loss = trainer.step(batch)
"""
from __future__ import annotations

import contextlib
from typing import Generator

import torch
import torch.profiler

__all__ = ["annotate", "profile"]

annotate = torch.profiler.record_function


@contextlib.contextmanager
def profile(log_dir: str, *, create_perfetto_link: bool = False) -> Generator[None, None, None]:
    """Traces everything inside the block into a ``*.pt.trace.json`` file in
    ``log_dir``. ``create_perfetto_link`` (a JAX profiler feature that serves
    the trace to the Perfetto UI) is not available and raises
    ``NotImplementedError``: open the file in Perfetto instead."""
    if create_perfetto_link:
        raise NotImplementedError("profile(create_perfetto_link=True): open the trace file in Perfetto instead")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield

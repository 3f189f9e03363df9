"""TensorBoard monitoring tasks (counterpart of
``gpflow_tpu/monitor/tensorboard.py``).

The event files are written by ``torch.utils.tensorboard.SummaryWriter``,
as in the JAX package, so both packages write the same tags and values.
``SummaryWriter`` (which needs the ``tensorboard`` package) and matplotlib
(for ``ImageToTensorBoard``) are imported when a task is built; where one is
missing, building the task raises ``ImportError`` naming it. A task reads
the model on the host when it runs, between optimization steps.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..utilities.traversal import _host_values, parameter_dict
from .base import MonitorTask

if TYPE_CHECKING:  # the models load on first use
    from ..models.model import BayesianModel

__all__ = ["ImageToTensorBoard", "ModelToTensorBoard", "ScalarToTensorBoard", "ToTensorBoard"]


class ToTensorBoard(MonitorTask):
    """Owns an event-file writer. Writers are shared per ``log_dir``, so
    tasks that log to one directory write one event file; each holds an open
    file and a flush thread until :meth:`close_writer` or
    :meth:`close_all_writers` releases it."""

    writers: Dict[str, Any] = {}

    def __init__(self, log_dir: str) -> None:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                f"{type(self).__name__} needs the tensorboard package (torch.utils.tensorboard)"
            ) from e
        if log_dir not in self.writers:
            self.writers[log_dir] = SummaryWriter(log_dir=log_dir)
        self.log_dir = log_dir
        self.file_writer = self.writers[log_dir]

    def __call__(self, step: int, **kwargs: Any) -> None:
        super().__call__(step, **kwargs)
        self.file_writer.flush()

    @classmethod
    def close_writer(cls, log_dir: str) -> None:
        """Flushes, closes and forgets the shared writer of ``log_dir``, if any."""
        writer = cls.writers.pop(log_dir, None)
        if writer is not None:
            writer.close()

    @classmethod
    def close_all_writers(cls) -> None:
        """Flushes, closes and forgets every shared writer."""
        for log_dir in list(cls.writers):
            cls.close_writer(log_dir)


class ModelToTensorBoard(ToTensorBoard):
    """Writes the model's parameters whose paths hold one of
    ``keywords_to_monitor`` ("*" for all) as scalars, at most ``max_size``
    entries of each (-1 for all). The matching parameters come to the host
    in one copy per call."""

    def __init__(
        self,
        log_dir: str,
        model: BayesianModel,
        *,
        max_size: int = 3,
        keywords_to_monitor: Optional[List[str]] = None,
        left_strip_character: str = ".",
    ) -> None:
        super().__init__(log_dir)
        self.model = model
        self.max_size = max_size
        self.keywords_to_monitor = (
            keywords_to_monitor if keywords_to_monitor is not None else ["kernel", "likelihood"]
        )
        self.summarize_all = "*" in self.keywords_to_monitor
        self.left_strip_character = left_strip_character

    def run(self, **unused_kwargs: Any) -> None:
        selected = {
            name.lstrip(self.left_strip_character): p
            for name, p in parameter_dict(self.model).items()
            if self.summarize_all or any(k in name for k in self.keywords_to_monitor)
        }
        for name, value in zip(selected, _host_values(list(selected.values()))):
            self._summarize_parameter(name, value)

    def _summarize_parameter(self, name: str, value: np.ndarray) -> None:
        values = value.reshape(-1)
        size = values.shape[0]
        if size == 1:
            self.file_writer.add_scalar(name, float(values[0]), self.current_step)
        else:
            count = size if self.max_size == -1 else min(size, self.max_size)
            for i in range(count):
                self.file_writer.add_scalar(f"{name}[{i}]", float(values[i]), self.current_step)


class ScalarToTensorBoard(ToTensorBoard):
    """Writes ``callback(**kwargs)`` as the scalar ``name``."""

    def __init__(self, log_dir: str, callback: Callable[..., float], name: str) -> None:
        super().__init__(log_dir)
        self.name = name
        self.callback = callback

    def run(self, **kwargs: Any) -> None:
        value = self.callback(**kwargs)
        if isinstance(value, torch.Tensor):
            value = value.detach()  # a loss that carries its graph
        self.file_writer.add_scalar(self.name, float(value), self.current_step)


class ImageToTensorBoard(ToTensorBoard):
    """Writes the figure that ``plotting_function(fig, axes)`` draws with
    matplotlib as the image ``name``."""

    def __init__(
        self,
        log_dir: str,
        plotting_function: Callable[..., None],
        name: Optional[str] = None,
        *,
        fig_kw: Optional[Dict[str, Any]] = None,
        subplots_kw: Optional[Dict[str, Any]] = None,
    ) -> None:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("ImageToTensorBoard needs the matplotlib package") from e
        super().__init__(log_dir)
        self.plotting_function = plotting_function
        self.name = name or "image"
        self.fig_kw = fig_kw or {}
        self.subplots_kw = subplots_kw or {}

    def run(self, **unused_kwargs: Any) -> None:
        # a Figure with its own Agg canvas draws without touching the
        # process-wide matplotlib backend
        from matplotlib.backends.backend_agg import FigureCanvasAgg
        from matplotlib.figure import Figure

        fig = Figure(**self.fig_kw)
        canvas = FigureCanvasAgg(fig)
        axes = fig.subplots(**self.subplots_kw) if self.subplots_kw else fig.add_subplot(111)
        self.plotting_function(fig, axes)
        canvas.draw()
        buf = np.asarray(canvas.buffer_rgba())[..., :3]  # [H, W, 3]
        self.file_writer.add_image(self.name, buf, self.current_step, dataformats="HWC")

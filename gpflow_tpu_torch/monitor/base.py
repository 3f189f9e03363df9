"""Monitoring tasks and their scheduler (counterpart of
``gpflow_tpu/monitor/base.py``)."""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Collection, Union

__all__ = ["ExecuteCallback", "Monitor", "MonitorTask", "MonitorTaskGroup"]


class MonitorTask(ABC):
    """A callable monitoring task; subclasses implement ``run``."""

    def __call__(self, step: int, **kwargs: Any) -> None:
        self.current_step = int(step)
        self.run(**kwargs)

    @abstractmethod
    def run(self, **kwargs: Any) -> None:
        raise NotImplementedError


class ExecuteCallback(MonitorTask):
    """Calls ``callback(**kwargs)`` as a task."""

    def __init__(self, callback: Callable[..., None]) -> None:
        self.callback = callback

    def run(self, **kwargs: Any) -> None:
        self.callback(**kwargs)


class MonitorTaskGroup:
    """Tasks that run together at every ``period``-th step."""

    def __init__(
        self, task_or_tasks: Union[Collection[MonitorTask], MonitorTask], period: int = 1
    ) -> None:
        self._tasks: Collection[MonitorTask] = []
        self.tasks = task_or_tasks  # type: ignore[assignment]
        self._period = period

    @property
    def tasks(self) -> Collection[MonitorTask]:
        return self._tasks

    @tasks.setter
    def tasks(self, task_or_tasks: Union[Collection[MonitorTask], MonitorTask]) -> None:
        if isinstance(task_or_tasks, MonitorTask):
            self._tasks = [task_or_tasks]
        else:
            self._tasks = list(task_or_tasks)

    def __call__(self, step: int, **kwargs: Any) -> None:
        if step % self._period == 0:
            for task in self.tasks:
                task(step, **kwargs)


class Monitor:
    """Runs task groups, each at its period.

    Example::

        fast = MonitorTaskGroup([model_task, elbo_task], period=1)
        slow = MonitorTaskGroup(image_task, period=5)
        monitor = Monitor(fast, slow)
        for step in range(1000):
            ...optimization step...
            monitor(step)
    """

    def __init__(self, *task_groups: MonitorTaskGroup) -> None:
        self.task_groups = task_groups

    def __call__(self, step: int, **kwargs: Any) -> None:
        for group in self.task_groups:
            group(step, **kwargs)

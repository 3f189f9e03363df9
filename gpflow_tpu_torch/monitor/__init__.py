"""Monitoring during optimization (counterpart of ``gpflow_tpu/monitor/``)."""
from .base import ExecuteCallback, Monitor, MonitorTask, MonitorTaskGroup
from .tensorboard import (
    ImageToTensorBoard,
    ModelToTensorBoard,
    ScalarToTensorBoard,
    ToTensorBoard,
)

__all__ = [
    "ExecuteCallback",
    "ImageToTensorBoard",
    "ModelToTensorBoard",
    "Monitor",
    "MonitorTask",
    "MonitorTaskGroup",
    "ScalarToTensorBoard",
    "ToTensorBoard",
]

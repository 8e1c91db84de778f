"""AIR-surface extras: experiment-tracking integrations + callbacks.

Counterpart of ``ray_tpu/air`` (ref: python/ray/air/integrations/wandb.py
WandbLoggerCallback, mlflow.py MLflowLoggerCallback): thin logger callbacks
the port's tune controller invokes on every trial start, report and
completion, driver-side. Import-gated — a missing wandb/mlflow package
fails at CONSTRUCTION (loudly, driver-side), never mid-experiment on a
worker.
"""

from ray_tpu_torch.air.integrations import (
    LoggerCallback,
    MLflowLoggerCallback,
    WandbLoggerCallback,
)

__all__ = [
    "LoggerCallback",
    "MLflowLoggerCallback",
    "WandbLoggerCallback",
]

"""ray_tpu_torch.serve — the serving pieces the LLM layer rides on.

Port-side copies of the pure-Python parts of ``ray_tpu/serve``: the typed
errors (``BackPressureError``, ...), ``batch`` (an asyncio queue that
coalesces concurrent calls, with the AIMD batch-size controller), and the
authoring data (``deployment``, ``Deployment``, ``Application``, the
config dataclasses). ``serve.run``, replicas, handles and proxies ride on
the JAX package's actor runtime, which the port does not copy.
"""
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.exceptions import (
    BackPressureError,
    RayServeException,
    ReplicaUnavailableError,
    RequestCancelledError,
    RequestTimeoutError,
)

__all__ = [
    "Application",
    "AutoscalingConfig",
    "BackPressureError",
    "Deployment",
    "DeploymentConfig",
    "RayServeException",
    "ReplicaUnavailableError",
    "RequestCancelledError",
    "RequestTimeoutError",
    "batch",
    "deployment",
]

"""ray_tpu_torch.serve — model serving on the port's own actor runtime.

Counterpart of ``ray_tpu/serve`` (ref: python/ray/serve/): a controller
actor reconciles replica sets (controller.py:87, deployment_state.py:1266),
handle-side routers balance with power-of-two-choices over in-flight counts
(request_router/pow_2_router.py:27), queue-depth autoscaling
(autoscaling_policy.py), @serve.batch coalesces concurrent requests into
card-sized batches, and optional aiohttp / gRPC ingresses proxy HTTP
(proxy.py:1137); aiohttp and grpc are imported only when a proxy starts.
Replicas are ``ray_tpu_torch`` actors: ``ray_actor_options={"num_gpus":
1}`` leases a whole card by id (``CUDA_VISIBLE_DEVICES``), as the
runtime's other leases do.

    import ray_tpu_torch
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Model.bind())
    ray_tpu_torch.get(handle.remote(21))  # -> 42
"""
from __future__ import annotations

import time

from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application, Deployment, build_specs, deployment
from ray_tpu_torch.serve.exceptions import (
    BackPressureError,
    RayServeException,
    ReplicaUnavailableError,
    RequestCancelledError,
    RequestTimeoutError,
)
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.schema import (
    DeploymentSchema,
    ServeApplicationSchema,
    ServeDeploySchema,
    build_config,
    deploy_config,
)
from ray_tpu_torch.serve.streaming import ServeStream, StreamBrokenError

__all__ = [
    "AutoscalingConfig",
    "Application",
    "BackPressureError",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentSchema",
    "ReplicaUnavailableError",
    "RequestCancelledError",
    "RequestTimeoutError",
    "ServeApplicationSchema",
    "ServeDeploySchema",
    "ServeStream",
    "StreamBrokenError",
    "build_config",
    "deploy_config",
    "RayServeException",
    "batch",
    "deployment",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "start_grpc_proxy",
    "start_http_proxy",
    "status",
]


def start_http_proxy(host: str = "127.0.0.1", port: int = 0) -> tuple:
    """Start the aiohttp ingress actor (ref: serve proxy per node)."""
    from ray_tpu_torch.serve.http_proxy import start_http_proxy as _start

    start()
    return _start(host, port)


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0) -> tuple:
    """Start the gRPC ingress actor (ref: proxy.py:530 gRPCProxy)."""
    from ray_tpu_torch.serve.grpc_proxy import start_grpc_proxy as _start

    start()
    return _start(host, port)


def _get_or_create_controller():
    import ray_tpu_torch
    from ray_tpu_torch.core.api import remote

    handle = ray_tpu_torch.get_core().get_actor_by_name(CONTROLLER_NAME)
    if handle is not None:
        return handle
    return (
        remote(ServeController)
        .options(name=CONTROLLER_NAME, get_if_exists=True, num_cpus=0.1,
                 max_restarts=3)
        .remote()
    )


def start():
    """Bring up the Serve control plane without deploying anything."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    return _get_or_create_controller()


def run(app: Application, *, name: str = "default", timeout_s: float = 120.0,
        _blocking: bool = True) -> DeploymentHandle:
    """Deploy a bound application graph; returns the ingress handle
    (ref: serve/api.py:675 serve.run)."""
    import ray_tpu_torch

    if not isinstance(app, Application):
        raise TypeError("serve.run takes a bound application: Deployment.bind(...)")
    controller = start()
    ingress, specs = build_specs(app, name)
    refs = [
        controller.deploy.remote(name, dep_name, spec)
        for dep_name, spec in specs.items()
    ]
    ray_tpu_torch.get(refs, timeout=30)
    if _blocking:
        # all deployments come up concurrently: one batched get over the
        # wait_ready refs instead of waiting out each deployment in turn.
        # Each wait gets the CUMULATIVE budget the old sequential loop
        # allowed (windows started after the previous deployment was
        # ready), so replicas that place one at a time on a constrained
        # cluster still pass; the get returns as soon as all are ready.
        budget_s = timeout_s * max(1, len(specs))
        ready = ray_tpu_torch.get(
            [controller.wait_ready.remote(name, dep_name, budget_s)
             for dep_name in specs],
            timeout=budget_s + 10,
        )
        for dep_name, ok in zip(specs, ready):
            if not ok:
                raise RayServeException(
                    f"deployment {name}/{dep_name} failed to become ready "
                    f"within {budget_s}s"
                )
    return DeploymentHandle(ingress, app_name=name)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name=app_name)


def status() -> dict:
    import ray_tpu_torch

    controller = ray_tpu_torch.get_core().get_actor_by_name(CONTROLLER_NAME)
    if controller is None:
        return {}
    return ray_tpu_torch.get(controller.get_status.remote(), timeout=30)


def delete(app_name: str = "default", timeout_s: float = 30.0):
    import ray_tpu_torch

    controller = ray_tpu_torch.get_core().get_actor_by_name(CONTROLLER_NAME)
    if controller is None:
        return
    ray_tpu_torch.get(controller.delete_app.remote(app_name), timeout=30)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = status()
        if app_name not in st or not st[app_name]:
            return
        time.sleep(0.1)


def shutdown():
    """Tear down all applications and the controller."""
    import ray_tpu_torch

    if not ray_tpu_torch.is_initialized():
        return
    from ray_tpu_torch.serve.grpc_proxy import PROXY_NAME as GRPC_PROXY_NAME
    from ray_tpu_torch.serve.http_proxy import PROXY_NAME

    for proxy_name in (PROXY_NAME, GRPC_PROXY_NAME):
        proxy = ray_tpu_torch.get_core().get_actor_by_name(proxy_name)
        if proxy is not None:
            try:
                ray_tpu_torch.get(proxy.shutdown.remote(), timeout=10)
            except Exception:  # raylint: disable=RT012 — shutdown best-effort; the kill below is the backstop
                pass
            try:
                ray_tpu_torch.kill(proxy)
            except Exception:  # raylint: disable=RT012 — teardown: proxy may already be dead
                pass
    controller = ray_tpu_torch.get_core().get_actor_by_name(CONTROLLER_NAME)
    if controller is None:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
    except Exception:  # raylint: disable=RT012 — shutdown best-effort; the kill below is the backstop
        pass
    try:
        ray_tpu_torch.kill(controller)
    except Exception:  # raylint: disable=RT012 — teardown: controller may already be dead
        pass
    from ray_tpu_torch.serve import handle as _handle_mod

    with _handle_mod._routers_lock:
        for r in _handle_mod._routers.values():
            r.stop()
        _handle_mod._routers.clear()

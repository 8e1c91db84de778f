"""Deployment authoring: @serve.deployment + .bind() composition.

Equivalent of the reference authoring surface (ref:
python/ray/serve/deployment.py Deployment, api.py:675 serve.run;
deployment graph build via .bind). A Deployment wraps a user class with a
DeploymentConfig; .bind(*args) produces an Application node whose args may
themselves be bound deployments — serve.run deploys the whole graph and
wires child handles into parent init args.
"""
from __future__ import annotations

import dataclasses
from typing import Any

try:
    import cloudpickle
except ImportError:  # pragma: no cover
    import pickle as cloudpickle

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.replica import HandleMarker


@dataclasses.dataclass
class Application:
    """A bound deployment graph node (ref: serve Application)."""

    deployment: "Deployment"
    init_args: tuple
    init_kwargs: dict

    def _collect(self, seen: dict) -> None:
        """Walk the graph depth-first, registering every deployment node."""
        for arg in list(self.init_args) + list(self.init_kwargs.values()):
            if isinstance(arg, Application):
                arg._collect(seen)
        if self.deployment.name in seen and seen[self.deployment.name] is not self:
            raise ValueError(
                f"two different bindings share the deployment name "
                f"{self.deployment.name!r}; use .options(name=...) to rename"
            )
        seen[self.deployment.name] = self


class Deployment:
    def __init__(self, cls_or_fn: Any, name: str, config: DeploymentConfig):
        self._callable = cls_or_fn
        self.name = name
        self.config = config

    def options(self, *, name: str | None = None, num_replicas: int | None = None,
                max_ongoing_requests: int | None = None,
                autoscaling_config: AutoscalingConfig | dict | None = None,
                user_config: dict | None = None,
                ray_actor_options: dict | None = None,
                max_request_retries: int | None = None,
                request_timeout_s: float | None = None,
                retry_on: tuple | list | str | None = None,
                hedge_after_ms: float | None = None,
                max_queued_requests: int | None = None,
                latency_slo_ms: float | None = None) -> "Deployment":
        cfg = dataclasses.replace(self.config)
        if num_replicas is not None:
            cfg.num_replicas = num_replicas
        if max_ongoing_requests is not None:
            cfg.max_ongoing_requests = max_ongoing_requests
        if autoscaling_config is not None:
            if isinstance(autoscaling_config, dict):
                autoscaling_config = AutoscalingConfig(**autoscaling_config)
            cfg.autoscaling_config = autoscaling_config
        if user_config is not None:
            cfg.user_config = user_config
        if ray_actor_options is not None:
            cfg.ray_actor_options = dict(ray_actor_options)
        if max_request_retries is not None:
            cfg.max_request_retries = max_request_retries
        if request_timeout_s is not None:
            cfg.request_timeout_s = request_timeout_s
        if retry_on is not None:
            cfg.retry_on = retry_on
        if hedge_after_ms is not None:
            cfg.hedge_after_ms = hedge_after_ms
        if max_queued_requests is not None:
            cfg.max_queued_requests = max_queued_requests
        if latency_slo_ms is not None:
            cfg.latency_slo_ms = latency_slo_ms
        cfg.__post_init__()  # re-validate + renormalize retry_on
        return Deployment(self._callable, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


def deployment(cls_or_fn=None, *, name: str | None = None, num_replicas: int = 1,
               max_ongoing_requests: int = 8,
               autoscaling_config: AutoscalingConfig | dict | None = None,
               user_config: dict | None = None,
               health_check_period_s: float = 1.0,
               graceful_shutdown_timeout_s: float = 5.0,
               ray_actor_options: dict | None = None,
               max_request_retries: int = 3,
               request_timeout_s: float | None = None,
               retry_on: tuple | list | str = (),
               hedge_after_ms: float = 0.0,
               max_queued_requests: int = -1,
               latency_slo_ms: float | None = None):
    """@serve.deployment decorator (ref: serve/api.py deployment)."""

    def wrap(target):
        if isinstance(autoscaling_config, dict):
            auto = AutoscalingConfig(**autoscaling_config)
        else:
            auto = autoscaling_config
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=auto,
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            ray_actor_options=dict(ray_actor_options or {}),
            max_request_retries=max_request_retries,
            request_timeout_s=request_timeout_s,
            retry_on=retry_on,
            hedge_after_ms=hedge_after_ms,
            max_queued_requests=max_queued_requests,
            latency_slo_ms=latency_slo_ms,
        )
        return Deployment(target, name or target.__name__, cfg)

    if cls_or_fn is not None:
        return wrap(cls_or_fn)
    return wrap


def build_specs(app: Application, app_name: str) -> tuple[str, dict[str, dict]]:
    """Flatten a bound graph into controller deploy specs; nested bound
    deployments become HandleMarkers resolved replica-side."""
    seen: dict[str, Application] = {}
    app._collect(seen)

    def marker(a: Any):
        if isinstance(a, Application):
            return HandleMarker(a.deployment.name, app_name)
        return a

    specs = {}
    for name, node in seen.items():
        from ray_tpu_torch.utils import serialization

        specs[name] = {
            "serialized_cls": serialization.ship_dumps(node.deployment._callable),
            "init_args": tuple(marker(a) for a in node.init_args),
            "init_kwargs": {k: marker(v) for k, v in node.init_kwargs.items()},
            "config": node.deployment.config,
        }
    ingress = app.deployment.name
    return ingress, specs

"""Declarative Serve application config (ref: python/ray/serve/schema.py
ServeDeploySchema / ServeApplicationSchema / DeploymentSchema — the
config surface `serve deploy config.yaml` and the KubeRay RayService CRD
speak).

    applications:
      - name: text_app
        import_path: my_pkg.apps:app       # a bound Application object
        runtime_env: {working_dir: ./src}
        deployments:
          - name: Encoder
            num_replicas: 3
            max_ongoing_requests: 16
          - name: Router
            autoscaling_config: {min_replicas: 1, max_replicas: 4}

``deploy_config(dict_or_yaml_path)`` imports each application, applies
the per-deployment overrides, and serve.run()s them; ``build_config``
round-trips a running app back into this schema.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class DeploymentSchema:
    name: str
    num_replicas: int | None = None
    max_ongoing_requests: int | None = None
    autoscaling_config: dict | None = None
    latency_slo_ms: float | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentSchema":
        known = {k: d.get(k) for k in
                 ("name", "num_replicas", "max_ongoing_requests",
                  "autoscaling_config", "latency_slo_ms")}
        unknown = set(d) - set(known)
        if unknown:
            raise ValueError(f"deployment {d.get('name')!r}: unknown "
                             f"fields {sorted(unknown)}")
        if not known["name"]:
            raise ValueError("deployment entry needs a name")
        return cls(**known)


@dataclass
class ServeApplicationSchema:
    name: str
    import_path: str
    route_prefix: str | None = None
    runtime_env: dict | None = None
    deployments: list[DeploymentSchema] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "ServeApplicationSchema":
        known = {k: d.get(k) for k in
                 ("name", "import_path", "route_prefix", "runtime_env")}
        unknown = set(d) - set(known) - {"deployments"}
        if unknown:
            raise ValueError(f"application {d.get('name')!r}: unknown "
                             f"fields {sorted(unknown)}")
        if not known["name"] or not known["import_path"]:
            raise ValueError("application entries need name + import_path")
        deps = [DeploymentSchema.from_dict(x)
                for x in d.get("deployments", [])]
        return cls(deployments=deps, **known)

    def load_application(self):
        """Resolve import_path 'pkg.module:attr' to the bound app."""
        if ":" not in self.import_path:
            raise ValueError(
                f"import_path {self.import_path!r} must be "
                "'module.path:app_variable'")
        mod_name, attr = self.import_path.split(":", 1)
        mod = importlib.import_module(mod_name)
        app = getattr(mod, attr)
        from ray_tpu_torch.serve.deployment import Application

        if not isinstance(app, Application):
            raise TypeError(
                f"{self.import_path} is {type(app).__name__}, expected a "
                "bound Application (Deployment.bind(...))")
        return app


@dataclass
class ServeDeploySchema:
    applications: list[ServeApplicationSchema]

    @classmethod
    def from_dict(cls, d: dict) -> "ServeDeploySchema":
        apps = d.get("applications")
        if not isinstance(apps, list) or not apps:
            raise ValueError("config needs a non-empty 'applications' list")
        names = [a.get("name") for a in apps]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate application names in {names}")
        return cls([ServeApplicationSchema.from_dict(a) for a in apps])


def _load(config) -> ServeDeploySchema:
    if isinstance(config, ServeDeploySchema):
        return config
    if isinstance(config, str):
        import yaml

        with open(config) as f:
            config = yaml.safe_load(f)
    return ServeDeploySchema.from_dict(config)


# app name -> import_path of the last deploy_config deployment (lets
# build_config round-trip a running app)
_DEPLOYED_IMPORT_PATHS: dict[str, str] = {}


def deploy_config(config) -> dict:
    """Deploy every application in a config (dict, yaml path, or schema);
    returns {app_name: ingress DeploymentHandle} (ref: serve deploy /
    _private/api.py serve_start + deploy_apps).

    All applications validate (import, field support, deployment names)
    BEFORE any deploys, so a config error never leaves a partial
    rollout."""
    from ray_tpu_torch import serve

    schema = _load(config)
    prepared = []
    for app in schema.applications:
        if app.route_prefix is not None:
            raise ValueError(
                f"app {app.name!r}: route_prefix is not supported — the "
                "HTTP/gRPC proxies route by /{app}/{deployment}")
        if app.runtime_env is not None:
            raise ValueError(
                f"app {app.name!r}: per-application runtime_env is not "
                "supported yet; apply it at ray_tpu_torch.init(runtime_env=...)")
        bound = app.load_application()
        prepared.append((app, _with_overrides(bound, app)))
    handles = {}
    for app, bound in prepared:
        handles[app.name] = serve.run(bound, name=app.name)
        _DEPLOYED_IMPORT_PATHS[app.name] = app.import_path
    return handles


def _copy_graph(node, memo: dict):
    """Rebuild an Application graph with fresh nodes (sharing Deployment
    objects and non-Application args). importlib returns the CACHED module,
    so the module-level Application object is the same across deploys —
    mutating its nodes would leak one deploy's overrides into the next.
    Memoized by original-node identity so diamond graphs keep sharing a
    single copy per node (Application._collect checks node identity)."""
    from ray_tpu_torch.serve.deployment import Application

    got = memo.get(id(node))
    if got is not None:
        return got

    def cp(a):
        return _copy_graph(a, memo) if isinstance(a, Application) else a

    new = Application(
        node.deployment,
        tuple(cp(a) for a in node.init_args),
        {k: cp(v) for k, v in node.init_kwargs.items()},
    )
    memo[id(node)] = new
    return new


def _with_overrides(bound, app: ServeApplicationSchema):
    """Validate + apply deployment overrides on a COPY of the bound graph
    via Deployment.options() copies — neither the module-level Deployment
    singletons nor the cached module's Application nodes are mutated, so
    a later deploy (or plain serve.run of the same import) sees the
    decorator defaults."""
    bound = _copy_graph(bound, {})
    nodes: dict = {}
    bound._collect(nodes)
    overrides = {d.name: d for d in app.deployments}
    missing = set(overrides) - set(nodes)
    if missing:
        raise ValueError(
            f"app {app.name!r}: config names deployments {sorted(missing)} "
            f"not present in the graph (has {sorted(nodes)})")
    for name, node in nodes.items():
        o = overrides.get(name)
        if o is None:
            continue
        node.deployment = node.deployment.options(
            num_replicas=o.num_replicas,
            max_ongoing_requests=o.max_ongoing_requests,
            autoscaling_config=o.autoscaling_config,
            latency_slo_ms=o.latency_slo_ms,
        )
    return bound


def build_config(app_name: str = "default") -> dict:
    """Render a running application's deployments back into the schema
    shape (ref: serve build). The import_path round-trips when the app
    was deployed through deploy_config; apps deployed via serve.run()
    get a placeholder to fill in."""
    from ray_tpu_torch import serve

    status = serve.status().get(app_name, {})
    return {
        "applications": [{
            "name": app_name,
            "import_path": _DEPLOYED_IMPORT_PATHS.get(
                app_name, "<module>:<app>"),
            "deployments": [
                {"name": dep, "num_replicas": info.get("target_replicas",
                                                       info.get("replicas"))}
                for dep, info in status.items()
            ],
        }]
    }

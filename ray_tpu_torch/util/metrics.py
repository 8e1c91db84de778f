"""User-facing metrics API (ref: ray.util.metrics Counter/Gauge/Histogram,
util/metrics.py:163/:216/:294).

Metrics defined in driver, task, or actor code register in the process-
local registry and ride the same export pipeline as the runtime's own
metrics (worker flush -> GCS -> ray_tpu_torch.state.cluster_metrics /
dashboard), tagged per the declared tag_keys::

    from ray_tpu_torch.util.metrics import Counter
    requests = Counter("app_requests", description="...", tag_keys=("route",))
    requests.inc(tags={"route": "/infer"})
"""

from ray_tpu_torch.utils.metrics import Counter, Gauge, Histogram

__all__ = ["Counter", "Gauge", "Histogram"]

"""ray_tpu_torch.serve.dataplane — the serve layer's production data plane.

The control plane (controller.py reconciliation, membership long-polls)
and the request FT machinery (handle.py retries/deadlines/hedging) were
built by earlier PRs; this package is the throughput/latency half of the
millions-of-users story (ROADMAP item 2):

- :mod:`fastlane` — same-node replica calls ride the actor shm
  rings instead of the actor RPC plane: per-replica frozen
  ``ActorCallTemplate``s, replies resolved directly into the router's
  coroutine (``CoreClient.fast_actor_submit_loop``), per-CALL RPC
  fallback so the promise-ref retry/hedge/deadline machinery above is
  untouched.
- :mod:`batching` — AIMD batch-size control for ``@serve.batch``
  (Clipper's latency-feedback adaptive batching): grow the effective
  batch cap additively while measured batch p99 stays under the
  deployment's ``latency_slo_ms`` budget, cut it multiplicatively on
  breach.
- :mod:`admission` — projected-queue-delay admission control: shed
  (typed ``BackPressureError`` → HTTP 429 / gRPC RESOURCE_EXHAUSTED)
  when the queue's projected wait already exceeds the request's
  remaining deadline, instead of executing work nobody will collect
  (Tail at Scale: good enough soon beats perfect late).
- :mod:`autoscaler` — SLO-feedback replica autoscaling: decisions made
  on (p99 vs SLO, smoothed ongoing, arrival rate) over a metrics
  window with hysteresis bands + cooldowns instead of the memoryless
  ``ceil(total/target)``; every decision carries its cause and is
  published on the ``serve_autoscale`` pubsub channel.
"""
from __future__ import annotations

from ray_tpu_torch.serve.dataplane.admission import AdmissionController
from ray_tpu_torch.serve.dataplane.autoscaler import (
    AutoscaleDecision,
    ServeAutoscaler,
)
from ray_tpu_torch.serve.dataplane.batching import AIMDBatchController
from ray_tpu_torch.serve.dataplane.fastlane import ReplicaLane, fastlane_enabled

__all__ = [
    "AIMDBatchController",
    "AdmissionController",
    "AutoscaleDecision",
    "ReplicaLane",
    "ServeAutoscaler",
    "fastlane_enabled",
]

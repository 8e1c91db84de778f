"""Serve configuration dataclasses.

A copy of ``ray_tpu/serve/config.py``: the authoring data of a deployment
(``AutoscalingConfig``, ``DeploymentConfig``) as plain picklable
dataclasses. The port has no controller or replicas to act on them; they
describe a deployment for whatever runs it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AutoscalingConfig:
    """SLO-feedback replica autoscaling with hysteresis (ref:
    serve/config.py AutoscalingConfig + _private/autoscaling_policy.py;
    policy implemented by serve/dataplane/autoscaler.py).

    Decisions read the MEAN (ongoing + handle-queued) count over
    ``metrics_window_s`` — never an instantaneous probe — plus the
    deployment's p99 vs its ``latency_slo_ms`` budget when one is set:

    - upscale when ceil(smoothed / target_ongoing_requests) exceeds the
      current count (stable for ``upscale_delay_s``), or immediately-ish
      on a p99 SLO breach (> ``slo_upscale_ratio`` x budget) — a
      multiplicative step up, bounded by ``max_replicas``.
    - downscale only to a count that keeps survivors at or under
      ``downscale_headroom`` x target (the hysteresis band), only while
      p99 sits under ``slo_downscale_ratio`` x budget, only after
      ``downscale_delay_s`` of stability AND ``cooldown_s`` since the
      last scale event of either direction.
    - scale-from-zero stays immediate (requests are blocked).
    """

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 1.0
    downscale_delay_s: float = 5.0
    metrics_interval_s: float = 0.25
    # --- SLO-feedback plane (serve/dataplane/autoscaler.py) ---
    #: smoothing window for the ongoing-count mean (the flap fix: a
    #: one-tick spike moves the average by dt/window, not to a new regime)
    metrics_window_s: float = 2.0
    #: downscale band: only shrink to counts keeping survivors at or
    #: under this fraction of target_ongoing_requests
    downscale_headroom: float = 0.7
    #: minimum distance from the last scale event before a downscale
    cooldown_s: float = 5.0
    #: p99 > slo * this ratio => upscale (needs DeploymentConfig.latency_slo_ms)
    slo_upscale_ratio: float = 1.0
    #: p99 > slo * this ratio => downscales are forbidden
    slo_downscale_ratio: float = 0.5

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < max(1, self.min_replicas):
            raise ValueError("need 0 <= min_replicas <= max_replicas, max >= 1")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")
        if self.metrics_window_s <= 0:
            raise ValueError("metrics_window_s must be > 0")
        if not 0 < self.downscale_headroom <= 1:
            raise ValueError("downscale_headroom must be in (0, 1]")
        if self.slo_downscale_ratio > self.slo_upscale_ratio:
            raise ValueError(
                "slo_downscale_ratio must be <= slo_upscale_ratio "
                "(the band between them is the hysteresis gap)")


@dataclasses.dataclass
class DeploymentConfig:
    """Per-deployment behavior (ref: serve/config.py DeploymentConfig).

    Request fault tolerance (the router/replica contract, see README
    § Serve fault tolerance):

    - ``max_request_retries``: per-request replay budget. Routing-time
      failures (backpressure, replica unreachable before dispatch) are
      always retryable; failures AFTER dispatch (replica died
      mid-request) replay only for methods the ``retry_on`` gate marks
      idempotent — a non-idempotent method effectively gets 0 retries
      for ambiguous failures.
    - ``request_timeout_s``: total per-request deadline, stamped by the
      handle and propagated to the replica (which sheds expired work
      instead of executing it) and into composed handle calls (nested
      deployments inherit the remaining budget). None = unbounded.
    - ``retry_on``: method names whose execution is idempotent and may
      be replayed/hedged; ``"*"`` marks every method.
    - ``hedge_after_ms``: tail-latency hedging (Dean & Barroso, The
      Tail at Scale) — after this many ms without a reply, send a
      second copy to a different replica and take the first result,
      cancelling the loser. 0 disables; only ``retry_on`` methods
      hedge. Recommended value: the deployment's p99 from the flight
      recorder's stage latencies (``state.list_task_latency()``).
    - ``max_queued_requests``: per-replica admission cap — beyond
      ``max_ongoing_requests`` executing plus this many queued, the
      replica refuses with ``BackPressureError`` (HTTP 429 /
      gRPC RESOURCE_EXHAUSTED at the proxies). The router applies the
      same cap to requests parked waiting for membership. -1 =
      unbounded.
    """

    num_replicas: int = 1
    max_ongoing_requests: int = 8  # per-replica concurrency cap
    autoscaling_config: AutoscalingConfig | None = None
    user_config: dict | None = None
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0
    graceful_shutdown_timeout_s: float = 5.0
    ray_actor_options: dict = dataclasses.field(default_factory=dict)
    # --- request fault tolerance ---
    max_request_retries: int = 3
    request_timeout_s: float | None = None
    retry_on: tuple = ()
    hedge_after_ms: float = 0.0
    max_queued_requests: int = -1
    # --- data plane (serve/dataplane) ---
    #: per-deployment latency budget, the ONE knob the data plane's
    #: feedback loops close against: the AIMD batch controller grows
    #: batch sizes while batch p99 stays under it, the autoscaler scales
    #: on deployment p99 vs it, and projected-queue-delay admission
    #: sheds work that cannot start inside it. None = no SLO: batching
    #: stays fixed-size, the autoscaler falls back to queue depth alone.
    latency_slo_ms: float | None = None
    # --- streaming SLOs (serve/streaming, wire 2.3) ---
    #: time-to-first-chunk budget for streaming requests (arrival ->
    #: first yielded item). None = inherit latency_slo_ms: a stream's
    #: first token races the whole-response budget by default.
    ttfc_slo_ms: float | None = None
    #: inter-chunk gap budget — breaches mean the stream STALLS
    #: mid-generation (decode batches saturating). None = gaps are
    #: recorded (p99 observable) but never counted as breaches.
    interchunk_slo_ms: float | None = None

    def __post_init__(self):
        if self.max_request_retries < 0:
            raise ValueError("max_request_retries must be >= 0")
        if self.request_timeout_s is not None and self.request_timeout_s <= 0:
            raise ValueError("request_timeout_s must be > 0 (None = unbounded)")
        if self.hedge_after_ms < 0:
            raise ValueError("hedge_after_ms must be >= 0 (0 = off)")
        if self.max_queued_requests < -1:
            raise ValueError("max_queued_requests must be >= -1")
        if self.latency_slo_ms is not None and self.latency_slo_ms <= 0:
            raise ValueError("latency_slo_ms must be > 0 (None = no SLO)")
        if self.ttfc_slo_ms is not None and self.ttfc_slo_ms <= 0:
            raise ValueError("ttfc_slo_ms must be > 0 (None = inherit)")
        if self.interchunk_slo_ms is not None and self.interchunk_slo_ms <= 0:
            raise ValueError("interchunk_slo_ms must be > 0 (None = off)")
        if isinstance(self.retry_on, str):
            self.retry_on = (self.retry_on,)
        else:
            self.retry_on = tuple(self.retry_on)

    def request_ft(self) -> dict:
        """The router-side slice of this config, shipped with routing
        info so handles pick up FT policy without a second RPC."""
        return {
            "max_request_retries": self.max_request_retries,
            "request_timeout_s": self.request_timeout_s,
            "retry_on": self.retry_on,
            "hedge_after_ms": self.hedge_after_ms,
            "max_queued_requests": self.max_queued_requests,
            # handle-side admission control (dataplane/admission.py)
            # projects queue delay from these two plus probed metrics
            "max_ongoing_requests": self.max_ongoing_requests,
            "latency_slo_ms": self.latency_slo_ms,
            "ttfc_slo_ms": self.ttfc_slo_ms,
            "interchunk_slo_ms": self.interchunk_slo_ms,
        }

    def initial_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return max(self.autoscaling_config.min_replicas, 1)
        return self.num_replicas

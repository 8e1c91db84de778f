"""Central flag table for the runtime.

Equivalent of the reference's ``RAY_CONFIG(type, name, default)``
table (ref: src/ray/common/ray_config_def.h:22) — a single declarative flag
registry, overridable per-process with ``RT_<NAME>`` environment variables and
serialized to every spawned process so the whole cluster agrees on one config.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any

_ENV_PREFIX = "RT_"
_SERIALIZED_ENV = "RT_SYSTEM_CONFIG"


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(_ENV_PREFIX + name.upper())
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # --- object store (plasma-equivalent; ref: src/ray/object_manager/plasma) ---
    object_store_memory: int = 512 * 1024 * 1024  # bytes of shm per node
    #: objects at or below this many bytes are returned inline in the task
    #: reply and live in the owner's in-process memory store
    #: (ref: RAY_CONFIG max_direct_call_object_size, ray_config_def.h:203).
    max_inline_object_size: int = 100 * 1024
    #: chunk size for inter-node object transfer
    object_transfer_chunk_size: int = 4 * 1024 * 1024
    #: spill sealed objects to disk when the arena passes this fraction
    #: (ref: local_object_manager.h:42 spill under pressure); <= 0 disables
    object_spilling_threshold: float = 0.8
    #: spill down to this fraction once triggered
    object_spilling_low_water: float = 0.6
    #: directory for spilled objects ("" = <temp_dir>/<session>/spill)
    object_spilling_dir: str = ""

    # --- memory tiering (spill/restore as a storage tier; ref:
    # pull_manager.h:49 admission window, local_object_manager.h:42) ---
    #: byte budget for concurrent restores/pulls in flight per raylet
    #: (PullManager-shaped admission window); excess queues FIFO
    pull_max_bytes_in_flight: int = 64 * 1024 * 1024
    #: seconds a queued pull/restore waits for admission before it is
    #: shed with a typed back-pressure error
    pull_admission_timeout_s: float = 30.0
    #: cooperative spill only claims arena-owner candidates untouched for
    #: at least this long (keeps mid-adoption pages hot)
    spill_cold_after_s: float = 0.25
    #: prefix cache spills unpinned pages to tier-1 instead of dropping
    #: them (the radix tree keeps the node; refs swap to disk)
    prefix_cache_spill: bool = True
    #: disk budget for tier-1 prefix-cache pages; beyond it the cache
    #: falls back to dropping LRU tier-1 leaves (the old eviction)
    prefix_cache_tier1_bytes: int = 1024 * 1024 * 1024

    # --- scheduler / raylet ---
    #: max workers a single raylet will fork
    max_workers_per_node: int = 64
    #: idle workers kept warm per node
    min_idle_workers: int = 1
    #: seconds before an idle leased worker is returned to the pool
    worker_lease_timeout_s: float = 10.0
    #: path to a C++ worker binary (rt_cpp_api.h + RT_REMOTE functions) for
    #: language="cpp" tasks; RT_CPP_WORKER env overrides (ref: cpp/ worker)
    cpp_worker_binary: str = ""
    #: place each worker in a kernel cgroup; a lease's "memory" resource
    #: becomes the worker's memory cap (ref: cgroup_manager.h "physical
    #: execution mode"). Needs a writable cgroup hierarchy.
    enable_worker_cgroups: bool = False
    #: hybrid scheduling: prefer local node until this utilization fraction
    #: (ref: hybrid_scheduling_policy.h:50)
    hybrid_threshold: float = 0.5
    #: concurrent lease requests per scheduling key (pipelined worker
    #: acquisition under bursts; ref: normal_task_submitter lease pipelining)
    max_lease_parallelism: int = 8
    #: max task specs pushed to a leased worker in one rpc frame — a deep
    #: backlog amortizes frame/pickle/loop-wakeup costs across the batch
    #: (ref: normal_task_submitter.cc direct PushTask pipelining)
    push_batch_size: int = 32

    # --- native fast path (shm task rings; ref: normal_task_submitter.cc
    # steady-state lease-cached PushTask loop — see core/fastpath.py) ---
    #: route eligible same-node task submissions over native shm rings
    fastpath_enabled: bool = True
    #: per-direction ring capacity in bytes
    fastpath_ring_bytes: int = 4 * 1024 * 1024
    #: task records above this size take the RPC path (big args belong in
    #: the object store, and the pop buffer must always fit one record)
    fastpath_record_max: int = 256 * 1024
    #: max unreplied fast-path tasks per worker before spilling to RPC
    fastpath_inflight_max: int = 4096
    #: coalesced ring flush: during a submit burst, records buffer until
    #: this many are pending (or fastpath_flush_max_bytes), then push in
    #: ONE native batch — one ring lock round + one consumer wake per
    #: batch instead of per record. 1 disables buffering entirely.
    fastpath_flush_max_records: int = 16
    #: byte cap for one coalesced flush batch
    fastpath_flush_max_bytes: int = 64 * 1024
    #: background flusher linger: how long a buffered burst tail may sit
    #: before the flusher thread pushes it (bounds worst-case added
    #: latency for fire-and-forget submits; get()/prepass flush sooner)
    fastpath_flush_linger_us: int = 300
    #: completion fast lane: results at or below this many bytes travel
    #: inside the ring completion record itself (no object-store put, no
    #: location registration); larger results are sealed into the node's
    #: shm arena and the record carries (size) so the driver's location
    #: cache is primed at completion time
    fastpath_inline_result_max: int = 8 * 1024
    #: how long the worker pump keeps retrying a partial reply-ring push
    #: before spilling the undelivered completion records to the driver
    #: over RPC (driver stalled / result ring full)
    fastpath_reply_spill_ms: int = 200
    #: serve data plane: route same-node replica calls over the actor shm
    #: rings (serve/dataplane) instead of the actor RPC plane; per-call
    #: RPC fallback (ref args, big payloads, broken lane) is always kept.
    #: Off switch for A/B (bench.py serve arm) and paranoia.
    serve_fastlane: bool = True

    # --- cross-node node tunnel (core/tunnel.py; ref: Pathways'
    # per-host dataflow channels — descriptors, not payloads, between
    # persistent per-host endpoints) ---
    #: route cross-node actor/serve/task calls over one persistent,
    #: multiplexed connection per node pair carrying the SAME packed
    #: wire records the shm rings use (coalesced frames instead of
    #: per-call pickled RPC specs); per-call RPC fallback always kept.
    #: Off switch for A/B (bench.py tunnel arm) and paranoia.
    node_tunnel: bool = True
    #: tunnel records above this many bytes do not ship their big args
    #: inline: each oversized top-level value seals into the sender's
    #: local shm arena and the record carries a (node, oid, nbytes)
    #: descriptor the receiver adopts via ONE batched pull
    tunnel_inline_max: int = 64 * 1024
    #: bench/test hook: bind tunnel lanes even for same-node actors
    #: (disables the same-node shm-ring shortcut so two raylets on one
    #: host exercise the full tunnel path)
    tunnel_force: bool = False
    #: reconnect-with-backoff ceiling for a broken tunnel connection;
    #: lanes break (per-call RPC fallback) the moment the tunnel drops
    #: and revive once the redial lands
    tunnel_reconnect_max_s: float = 5.0

    # --- native RPC mux (ref: grpc_server.h:88 completion-queue threads;
    # _native/src/mux.cc) ---
    #: serve control-plane RPC off a C++ epoll mux instead of asyncio
    #: streams (fan-in: N clients never serialize through per-connection
    #: reader coroutines); falls back to asyncio if the build is missing
    native_mux_enabled: bool = True
    #: the mux only engages on hosts with at least this many cores: its
    #: IO thread runs CONCURRENTLY with Python (the entire win), but on a
    #: 1-2 core host that thread and its eventfd wakes just preempt the
    #: interpreter — measured 25-35% slower there, faster with spare cores
    native_mux_min_cpus: int = 4

    # --- tracing (ref: util/tracing/tracing_helper.py span injection;
    # Dapper-style wire context — see utils/tracing.py) ---
    #: propagate span contexts through task specs AND the packed
    #: fast-lane/tunnel records (wire 2.1 trace leg), record spans into
    #: the task-event pipeline (state.list_spans / get_trace / timeline)
    tracing_enabled: bool = False
    #: head-based sampling: fraction of ROOTS (serve requests, driver
    #: .remote() calls with no active context) that start a sampled
    #: trace; children inherit the decision from the wire leg. The
    #: unsampled path is one contextvar read + one branch and ships no
    #: trace bytes (bench.py tracing_overhead_us).
    trace_sample_rate: float = 1.0
    #: GCS trace assembler: max assembled traces retained. Eviction
    #: protects the slowest ``trace_slow_keep`` fraction (the p99
    #: outliers you debug) and drops the oldest of the rest.
    trace_table_max: int = 512
    #: per-trace span cap (a runaway span loop can't eat the table)
    trace_spans_max: int = 512
    #: fraction of the slowest traces exempt from age-based eviction
    trace_slow_keep: float = 0.1
    #: ns="latency" KV retention: entries not republished for this many
    #: seconds (dead workers' leftover windows) are swept by the GCS
    #: health loop; <= 0 disables the sweep
    latency_retention_s: float = 600.0
    #: GCS task-event ring cap (also bounds the span history riding it)
    gcs_task_events_cap: int = 100_000

    # --- memory protection (ref: memory_monitor.h:52) ---
    #: fraction of system memory in use that triggers OOM killing;
    #: <= 0 disables the monitor
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_s: float = 1.0

    # --- GCS durability (ref: ray_config_def.h GCS storage knobs) ---
    #: opt-in machine-crash durability for the GCS WAL: every journaled
    #: table write is fdatasync'd (group-committed — concurrent writes in
    #: one loop tick share a single sync) before its RPC is acked, and
    #: snapshots fsync the tmp file before the rename plus the directory
    #: after it. Default off: the WAL is flushed to the OS page cache on
    #: every append, which survives a GCS process kill but not a machine
    #: crash/power loss.
    gcs_fsync: bool = False

    # --- chaos / fault injection (devtools/chaos; ref: the reference's
    # ResourceKiller-driven chaos tests, _private/test_utils.py:1419) ---
    #: arm the deterministic fault-injection controller in every process
    #: (driver, raylets, workers, GCS). Off = every chaos.point() site is
    #: a module-flag check compiled down to a falsy branch.
    chaos_enabled: bool = False
    #: ChaosPlan JSON: a file path, or an inline JSON object string
    chaos_plan: str = ""
    #: override the plan's seed (< 0 = use the plan's own)
    chaos_seed: int = -1
    #: fault-event JSONL dir ("" = <temp_dir>/chaos); read back by
    #: state.list_chaos_events() and `ray_tpu_torch chaos events`
    chaos_log_dir: str = ""

    # --- timeouts / health (ref: gcs_health_check_manager.h:59) ---
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5
    rpc_connect_timeout_s: float = 30.0
    worker_start_timeout_s: float = 60.0
    #: raylet-side lease on a PREPARED-but-uncommitted placement-group
    #: bundle reservation: if the coordinating GCS dies between the 2PC
    #: prepare and commit, the raylet returns the reservation after this
    #: many seconds instead of leaking the capacity forever (a repeated
    #: prepare — the GCS repairing/retrying — refreshes the lease);
    #: <= 0 disables the GC
    pg_bundle_lease_s: float = 30.0

    # --- task / actor fault tolerance ---
    default_max_task_retries: int = 3
    default_max_actor_restarts: int = 0
    #: max bytes of lineage kept per owner for reconstruction
    #: (ref: task_manager.h:182)
    lineage_bytes_limit: int = 64 * 1024 * 1024

    # --- observability ---
    task_events_report_interval_s: float = 1.0
    #: hot-path flight recorder (utils/recorder.py): always-on ring of
    #: ns-stamped stage events per process, < 1µs/task budget (bench.py
    #: recorder_overhead_us). Off switch for A/B and paranoia.
    recorder_enabled: bool = True
    #: slots per process recorder ring (also the driver's retained
    #: latency-sample window); fixed-size, drop-oldest
    recorder_events_cap: int = 4096
    log_dir: str = ""
    #: under the process temp directory ($TMPDIR), apart from the JAX
    #: package's /tmp/ray_tpu
    temp_dir: str = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")

    # --- collective ---
    #: default collective timeout
    collective_timeout_s: float = 120.0

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    # -- propagation to child processes -------------------------------------
    def to_env(self) -> dict:
        """Serialize so spawned processes reconstruct the identical config."""
        return {_SERIALIZED_ENV: json.dumps(dataclasses.asdict(self))}

    @classmethod
    def from_env(cls) -> "Config":
        raw = os.environ.get(_SERIALIZED_ENV)
        cfg = cls()
        if raw:
            for k, v in json.loads(raw).items():
                if hasattr(cfg, k):
                    setattr(cfg, k, v)
            # env vars still win over the serialized blob
            for f in dataclasses.fields(cfg):
                setattr(cfg, f.name, _env_override(f.name, getattr(cfg, f.name)))
        return cfg


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config.from_env()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg

"""Versioned wire schema for the control plane.

The role of the reference's protobuf schema tree (ref: src/ray/protobuf/
gcs_service.proto, node_manager.proto, core_worker.proto): one place that
names every RPC service, method, and payload field, with the version each
was introduced in. Peers exchange PROTOCOL_VERSION at connect time
(rpc.connect ``__hello__`` handshake) and refuse major mismatches; minor
additions are backwards-compatible (unknown payload keys are ignored by
every handler, the dict-payload equivalent of proto field skipping).

tests/test_wire_schema.py machine-checks this catalog against the live
``rpc_*`` handlers, so adding a method without cataloging it fails CI —
the same forcing function a .proto file provides.
"""

from __future__ import annotations

# (major, minor): bump MAJOR for incompatible changes (renamed/removed
# methods, changed field meaning), MINOR for additions.
#
# 1.7: flight-recorder telemetry on the fastpath shm records (not RPC
# methods, but versioned here because both sides must agree): task
# records may carry an 8-byte submit stamp (prefixes "Q"/"R" beside the
# unstamped "P"/"S"), and reply records may carry a 16-byte stage stamp
# (status flag 0x100) — see core/fastpath.py pack_task/pack_reply.
#
# 1.8: actor fast lane v2. Actor-lane task records use the "A"/"C"
# prefixes with a <u32 seq, u64 t_submit_ns> header (per-lane call
# sequence number); reply records may carry the echoed seq (status flag
# 0x200, 4 bytes after the optional stamp) so completions can stream
# back OUT of submission order (async actors) while ring order stays the
# per-caller FIFO dispatch invariant. attach_fast_ring's actor reply is
# now a dict carrying the actor's init-time method eligibility table —
# see core/fastpath.py pack_actor_task/pack_reply.
#
# 2.0: cross-node fast lane (MAJOR: OK_SHM payloads and record argument
# slots changed meaning). Node tunnels (core/tunnel.py) carry the shm
# rings' packed records between node pairs: raylet tunnel_bind /
# tunnel_frame / tunnel_detach + worker tunnel_attach / tunnel_records /
# tunnel_detach route coalesced record frames driver <-> raylet <->
# worker. OK_SHM reply payloads may carry <Q size><16s node> (the
# sealing node's id — the record IS the location registration,
# pack_shm_desc); record arguments may be TunnelArgRef descriptors
# ((oid, owner, node, nbytes) — oversized values adopt via the new
# batched pull_objects). Also batched control: raylet lease_workers,
# prepare_bundles, commit_bundles. The record prefix/flag byte catalog
# below (RECORD_PREFIXES / RECORD_FLAGS) is machine-checked against
# _native/src/rt_wire.h so a shipped-but-uncataloged wire entry fails
# tier-1 (PRs 10/11 both shipped one).
# 2.2: metric rollup queries. The GCS folds every ns="metrics" snapshot
# put into ring-buffered 1s/10s/60s windows (core/metrics_store.py) and
# serves them back: metric_window (rate/quantile series over trailing
# secs), metric_names (everything the rollup plane has seen + derived
# ratio series), metric_export (trailing counter rates, the prometheus
# :rate family feed). No record-plane changes.
# 2.1: wire-level trace context (Dapper-style — utils/tracing.py).
# "Q"/"R"/"A"/"C" records may carry a 25-byte trace leg
# (<16s trace_id><8s span_id><u8 sampled>) behind their header, flagged
# by TRACE_CTX_BIT (bit 63 of the u64 t_submit field — free for ~292
# years of CLOCK_MONOTONIC); seq-echoed replies may echo the leg
# (status flag 0x400, after the stamp/seq legs), so the driver's
# reply-apply stamps the wire-level call span for untracked serve
# fast-lane calls without a lookup. Unsampled records are byte-identical
# to 2.0 ones. Also: GCS get_trace / list_traces (the trace assembler),
# get_task_events limit/offset/span_only pagination.
# 2.3: streaming plane. Stream-called generator methods ride the actor
# lanes as ordinary "A"/"C" records whose method key uses the "gm:"
# marker (vs "am:"); the worker pumps flush one "G" chunk record per
# yielded item (core/fastpath.py pack_chunk — the "A" header shape with
# the seq slot carrying the per-stream chunk index, same TRACE_BIT trace
# leg) with body status CHUNK (inline packed item) or CHUNK_SHM
# (oversized item sealed under return index chunk_seq + 1, payload =
# shm size/desc like OK_SHM), then ONE ordinary terminal reply (OK +
# <u32 nchunks> / ERR) on the lane's seq machinery. Reply STATUS CODES
# are now cataloged (RECORD_STATUS below, mirrored by rt_wire.h
# kReplyStatus*) beside the prefix/flag bytes. Also: worker
# stream_abandon (driver stops an open stream's pump mid-flight —
# client disconnect), serve-level mid-stream cancellation rides the
# existing cancel_request actor method.
PROTOCOL_VERSION = (2, 3)

# ------------------------------------------------------ fastpath records
# Every record prefix byte and reply-status flag the shm rings / node
# tunnels ship (core/fastpath.py). rt_wire.h mirrors this catalog for
# native peers; tests/test_wire_schema.py asserts byte-for-byte parity
# in BOTH directions, so adding a prefix or flag on either side without
# cataloging it here is a tier-1 failure.
RECORD_PREFIXES: dict[str, dict] = {
    "P": {"since": (1, 3), "doc": "task record, C-pickled body, no stamp"},
    "S": {"since": (1, 3), "doc": "task record, serialization.pack body"},
    "Q": {"since": (1, 7), "doc": "task record, C-pickled, u64 submit stamp"},
    "R": {"since": (1, 7), "doc": "task record, packed, u64 submit stamp"},
    "A": {"since": (1, 8), "doc": "actor record, C-pickled, <u32 seq, u64 t>"},
    "C": {"since": (1, 8), "doc": "actor record, packed, <u32 seq, u64 t>"},
    "G": {"since": (2, 3), "doc": "stream chunk, 'A' header shape with the "
                                  "seq slot = per-stream chunk index, body "
                                  "<16s task_id><u32 status> + payload"},
}
# Reply status CODES (low bits of the reply/chunk status word, below the
# flag bits): cataloged since 2.3 alongside the flags — rt_wire.h mirrors
# them as kReplyStatus* and tests/test_wire_schema.py asserts parity in
# both directions like the prefixes/flags.
RECORD_STATUS: dict[str, dict] = {
    "OK": {"value": 0, "since": (1, 3), "doc": "payload = packed value"},
    "OK_SHM": {"value": 1, "since": (1, 3),
               "doc": "result sealed in the node arena; payload = "
                      "shm size (1.7) / <Q size><16s node> desc (2.0)"},
    "ERR": {"value": 2, "since": (1, 3), "doc": "payload = pickled error"},
    "NEED_SLOW": {"value": 3, "since": (1, 3),
                  "doc": "declined without executing: RPC path owns it"},
    "CHUNK": {"value": 4, "since": (2, 3),
              "doc": "'G' records only: one inline packed stream item"},
    "CHUNK_SHM": {"value": 5, "since": (2, 3),
                  "doc": "'G' records only: oversized item sealed under "
                         "return index chunk_seq + 1; payload = shm "
                         "size/desc"},
}
RECORD_FLAGS: dict[str, dict] = {
    "STAMPED": {"value": 0x100, "since": (1, 7),
                "doc": "reply carries a 16-byte worker stage stamp"},
    "SEQED": {"value": 0x200, "since": (1, 8),
              "doc": "reply echoes the submit record's u32 seq"},
    "TRACED": {"value": 0x400, "since": (2, 1),
               "doc": "reply echoes the submit record's 25-byte trace "
                      "leg (after the stamp/seq legs)"},
}
# Record-side trace flag (2.1): bit 63 of the u64 t_submit field of
# "Q"/"R"/"A"/"C" records — set = a 25-byte trace leg follows the
# record header. Mirrored by rt_wire.h kRecordTraceCtxBit/kTraceCtxLen
# and asserted against core/fastpath.py by tests/test_wire_schema.py.
TRACE_CTX_BIT = 1 << 63
TRACE_CTX_LEN = 25

# service -> method -> {"since": (major, minor), "fields": {...}}
# field values document type + meaning; "->" entries are the reply shape.
CATALOG: dict[str, dict[str, dict]] = {
    # ---------------------------------------------------------------- GCS
    # (ref: gcs_service.proto services)
    "gcs": {
        "register_node": {"since": (1, 0), "fields": {
            "node_id": "hex", "address": "(host, port)", "resources": "dict",
            "labels": "dict", "store_name": "str", "->": "cluster view"}},
        "register_job": {"since": (1, 0), "fields": {"job_id": "hex"}},
        "register_actor": {"since": (1, 0), "fields": {
            "actor_id": "ActorID", "cls_blob": "bytes", "opts": "dict"}},
        "get_actor": {"since": (1, 0), "fields": {
            "actor_id": "ActorID | None", "name": "str | None",
            "->": "actor info dict"}},
        "kill_actor": {"since": (1, 0), "fields": {
            "actor_id": "ActorID", "no_restart": "bool"}},
        "report_actor_death": {"since": (1, 0), "fields": {
            "actor_id": "ActorID", "reason": "str"}},
        "list_actors": {"since": (1, 0), "fields": {"->": "[actor info]"}},
        "heartbeat": {"since": (1, 0), "fields": {
            "node_id": "hex", "resources_available": "dict", "load": "dict",
            "version": "int — monotone view version (since 1.1)",
            "queued_leases": "int demand signal"}},
        "get_cluster": {"since": (1, 0), "fields": {"->": "[node info]"}},
        "drain_node": {"since": (1, 0), "fields": {"node_id": "hex"}},
        "subscribe": {"since": (1, 0), "fields": {"channels": "[str]"}},
        "publish": {"since": (1, 9), "fields": {
            "channel": "str — client-originated pubsub fan-out (the serve "
                       "controller's serve_autoscale decisions)",
            "message": "any"}},
        "kv_put": {"since": (1, 0), "fields": {
            "ns": "str", "key": "str", "value": "bytes", "overwrite": "bool"}},
        "kv_get": {"since": (1, 0), "fields": {"ns": "str", "key": "str"}},
        "kv_multi_get": {"since": (1, 0), "fields": {"ns": "str", "keys": "[str]"}},
        "kv_del": {"since": (1, 0), "fields": {"ns": "str", "key": "str"}},
        "kv_keys": {"since": (1, 0), "fields": {"ns": "str", "prefix": "str"}},
        "kv_exists": {"since": (1, 0), "fields": {"ns": "str", "key": "str"}},
        "create_placement_group": {"since": (1, 0), "fields": {
            "bundles": "[dict]", "strategy": "PACK|SPREAD|STRICT_*"}},
        "remove_placement_group": {"since": (1, 0), "fields": {"pg_id": "PGID"}},
        "get_placement_group": {"since": (1, 0), "fields": {"pg_id": "PGID"}},
        "list_placement_groups": {"since": (1, 0), "fields": {}},
        "report_task_events": {"since": (1, 0), "fields": {"events": "[dict]"}},
        "get_task_events": {"since": (1, 0), "fields": {
            "job_id": "hex | None", "limit": "int",
            "offset": "int (since (2, 1)) — newest-last pagination "
                      "window over the bounded event ring",
            "span_only": "bool (since (2, 1)) — only state='SPAN' rows "
                         "(state.list_spans pagination)"}},
        "get_trace": {"since": (2, 1), "fields": {
            "trace_id": "hex — one assembled trace from the bounded "
                        "trace table (span rows folded per trace_id on "
                        "report_task_events ingest)",
            "->": "{trace_id, spans: [span dict], start_ts, end_ts, "
                  "critical_path: TraceCriticalPath.compute()} | None"}},
        "list_traces": {"since": (2, 1), "fields": {
            "limit": "int", "offset": "int — newest first",
            "->": "[{trace_id, root_name, start_ts, dur_ms, n_spans, "
                  "procs, sealed}] — slow-trace retention keeps the p99 "
                  "outliers past the table cap"}},
        "metric_window": {"since": (2, 2), "fields": {
            "name": "metric or derived-ratio name (rt_* / "
                    "llm_spec_accept_rate / serve_slo_breach_fraction)",
            "secs": "trailing window length; picks the finest rollup "
                    "resolution (1s/10s/60s) whose retention covers it",
            "tags": "dict | None — exact tag-cell filter (default: "
                    "aggregate across cells)",
            "->": "{name, type, res, points: [{ts, ...}]} — counter "
                  "points carry value/rate, histograms count/sum/rate/"
                  "p50/p90/p99, ratios value/num/den (RollupStore.window)"}},
        "metric_names": {"since": (2, 2), "fields": {
            "->": "[{name, type}] — every metric the rollup plane has "
                  "seen plus its derived ratio series"}},
        "metric_export": {"since": (2, 2), "fields": {
            "secs": "trailing rate window (default 10)",
            "->": "{name: {type, samples: [{tags, rate}]}} — the "
                  "prometheus :rate<secs>s family feed"}},
    },
    # -------------------------------------------------------------- raylet
    # (ref: node_manager.proto NodeManagerService)
    "raylet": {
        "register_client": {"since": (1, 0), "fields": {
            "worker_id": "hex", "address": "(host, port)"}},
        "lease_worker": {"since": (1, 0), "fields": {
            "resources": "dict", "pg_id": "PGID | None", "bundle_index": "int",
            "owner_bound": "bool", "no_spill": "bool", "for_actor": "ActorID",
            "language": "python|cpp (since 1.1)",
            "strategy": "scheduling-strategy wire dict: {type: spread | "
                        "node_affinity | node_label, ...} (since 1.3)"}},
        "return_lease": {"since": (1, 0), "fields": {
            "lease_id": "int", "kill": "bool"}},
        "report_demand": {"since": (1, 3), "fields": {
            "count": "int — driver-side queued tasks no live lease will "
                     "absorb (autoscaler demand signal)"}},
        "heap_profile_worker": {"since": (1, 4), "fields": {
            "worker_id": "hex prefix — proxies a heap_profile RPC",
            "action": "start | snapshot | stop",
            "top": "snapshot: top-N allocation sites"}},
        "cpu_profile_worker": {"since": (1, 5), "fields": {
            "worker_id": "hex prefix — proxies a cpu_profile RPC",
            "duration_s": "sampling window (capped 30s)",
            "interval_s": "sample period"}},
        "dump_worker_stack": {"since": (1, 3), "fields": {
            "worker_id": "hex prefix — proxies a dump_stack RPC to the "
                         "matching worker (live stack profiling)"}},
        "worker_ready": {"since": (1, 0), "fields": {
            "worker_id": "hex", "address": "(host, port)", "pid": "int",
            "language": "str (since 1.1)"}},
        "get_lease_env": {"since": (1, 0), "fields": {"worker_id": "hex"}},
        "kill_worker": {"since": (1, 0), "fields": {"worker_id": "hex"}},
        "prepare_bundle": {"since": (1, 0), "fields": {
            "pg_id": "PGID", "bundle_index": "int", "resources": "dict"}},
        "commit_bundle": {"since": (1, 0), "fields": {
            "pg_id": "PGID", "bundle_index": "int"}},
        "return_bundle": {"since": (1, 0), "fields": {
            "pg_id": "PGID", "bundle_index": "int"}},
        "list_bundles": {"since": (1, 9), "fields": {
            "->": "[{pg_id, bundle_index, resources, committed, "
                  "prepared_at}] — the PG-reservation audit surface "
                  "(shipped in 1.8's PG-FT work, cataloged late)"}},
        "lease_workers": {"since": (2, 0), "fields": {
            "requests": "[lease_worker payloads] — batched grants in ONE "
                        "ledger pass; never parks (busy replies retry "
                        "caller-side)",
            "->": "[lease_worker replies], positional"}},
        "prepare_bundles": {"since": (2, 0), "fields": {
            "pg_id": "PGID", "bundles": "[(index, resources)] — one "
                                        "batched 2PC phase-1 ledger pass",
            "->": "[{ok}] positional"}},
        "commit_bundles": {"since": (2, 0), "fields": {
            "pg_id": "PGID", "indices": "[int] — batched 2PC phase 2",
            "->": "[{ok}] positional"}},
        "tunnel_bind": {"since": (2, 0), "fields": {
            "kind": "actor | task",
            "worker_id": "hex (task lanes)",
            "actor_id": "hex (actor lanes; the raylet resolves the "
                        "hosting worker)",
            "->": "{ok, lane, methods?} — lane id multiplexing this "
                  "binding over the node tunnel (core/tunnel.py)"}},
        "tunnel_frame": {"since": (2, 0), "fields": {
            "frames": "[(lane, framed record bytes)] — coalesced "
                      "ring-format records (notify, both directions: "
                      "driver->raylet submits, raylet->driver replies)"}},
        "tunnel_detach": {"since": (2, 0), "fields": {
            "lanes": "[lane ids] closed by the driver (notify)"}},
        "pull_objects": {"since": (2, 0), "fields": {
            "objects": "[{object_id, holders_hint}] — batched pull: one "
                       "round trip per arg/KV-manifest set, ONE GCS "
                       "kv_multi_get for the unhinted miss-set",
            "->": "{oid hex: bool}"}},
        "pull_object": {"since": (1, 0), "fields": {
            "object_id": "bytes", "owner_address": "(host, port)",
            "holders_hint": "[node_id bytes] optional (since (1, 6)): "
                            "location-cache hint tried before the GCS "
                            "directory; stale hints fall back in-call"}},
        "fetch_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "fetch_object_meta": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "fetch_object_chunk": {"since": (1, 0), "fields": {
            "object_id": "bytes", "offset": "int", "length": "int"}},
        "fetch_object_done": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "delete_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "get_log": {"since": (1, 1), "fields": {
            "worker_id": "hex (prefix ok)", "stream": "out|err",
            "tail": "int bytes", "->": "str | None"}},
        "register_spill_provider": {"since": (2, 2), "fields": {
            "address": "(host, port) — a local client process that can "
                       "serve cold arena-owner spill candidates "
                       "(core/tiering.py registry; shipped in the 2.2-era "
                       "memory-tiering work, cataloged late)"}},
        "spill_objects": {"since": (2, 2), "fields": {
            "object_ids": "[bytes] — owner-initiated spill of specific "
                          "sealed objects (prefix-cache spill-not-drop "
                          "eviction)",
            "->": "{oid hex: {ok, path}}"}},
        "spill_now": {"since": (1, 2), "fields": {
            "need": "int bytes of headroom wanted — spill pass runs to "
                    "low-water (ref: local_object_manager.h:42)"}},
        # cross-node DAG channels (the RegisterMutableObjectReader role,
        # ref: core_worker.proto:577)
        "channel_create": {"since": (1, 2), "fields": {
            "chan_id": "bytes", "size": "int", "num_readers": "int"}},
        "channel_push": {"since": (1, 2), "fields": {
            "chan_id": "bytes", "payload": "packed bytes (one version)"}},
        "channel_register_remote": {"since": (1, 2), "fields": {
            "chan_id": "bytes", "readers": "[(host, port)] mirror raylets"}},
        "channel_close": {"since": (1, 2), "fields": {"chan_id": "bytes"}},
    },
    # ------------------------------------------------- owner (CoreClient)
    # (ref: core_worker.proto owner-side RPCs)
    "owner": {
        "get_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "probe_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "wait_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "borrow_object": {"since": (1, 0), "fields": {
            "object_id": "bytes", "borrower": "hex"}},
        "unborrow_object": {"since": (1, 0), "fields": {
            "object_id": "bytes", "borrower": "hex"}},
        "recover_object": {"since": (1, 0), "fields": {"object_id": "bytes"}},
        "fast_result": {"since": (1, 6), "fields": {
            "records": "[reply record bytes] — completion records the "
                       "worker spilled over RPC when the result ring "
                       "stayed full (see core/fastpath.py)"}},
        "generator_item": {"since": (1, 0), "fields": {
            "task_id": "TaskID", "index": "int", "item": "packed | None",
            "done": "bool"}},
        "arena_spill_candidates": {"since": (2, 2), "fields": {
            "need": "int bytes of headroom wanted",
            "cold_after_s": "float — age gate for cold candidates",
            "->": "[(oid bytes, nbytes)] cold REFERENCED objects the "
                  "registered arena owners (core/tiering.py) may trade "
                  "to tier-1 (cataloged late, 2.2-era tiering)"}},
        "arena_spilled": {"since": (2, 2), "fields": {
            "spilled": "[(oid bytes, path, offset)] — owners stamp their "
                       "manifest entries' (tier, path) legs"}},
    },
    # ------------------------------------------------------------- worker
    # (ref: core_worker.proto PushTask + worker-side control)
    "worker": {
        "push_task": {"since": (1, 0), "fields": {"spec": "task spec dict"}},
        "push_actor_task": {"since": (1, 0), "fields": {
            "spec": "actor task spec", "seq": "int"}},
        "create_actor": {"since": (1, 0), "fields": {
            "actor_id": "ActorID", "cls_blob": "bytes", "args": "[arg]",
            "opts": "dict"}},
        "cancel_if_current": {"since": (1, 1), "fields": {"task_id": "TaskID"}},
        "push_task_multi": {"since": (1, 2), "fields": {
            "items": "[(corr_id, {spec})] — scatter push; one reply frame "
                     "per item as each task finishes"}},
        "push_actor_task_multi": {"since": (1, 2), "fields": {
            "items": "[(corr_id, {spec})] — scatter push of actor calls"}},
        "exit_worker": {"since": (1, 0), "fields": {}},
        "ping": {"since": (1, 0), "fields": {}},
        "start_dag_loop": {"since": (1, 0), "fields": {"schedule": "dict"}},
        "attach_fast_ring": {"since": (1, 3), "fields": {
            "name": "str — shm name of the task RingPair this worker "
                    "should pump (see core/fastpath.py)",
            "kind": "'actor' for actor-call rings (since 1.3)",
            "owner": "(host, port) optional (since (1, 6)): driver server "
                     "address — the result-ring spill target",
            "gpu_ids": "[str] optional: the lease's pinned cards, applied "
                       "as CUDA_VISIBLE_DEVICES before the first record",
            "->": "bool, or for actor rings since (1, 8) "
                  "{ok: bool, methods: {name: (sync|async|gen, group)}} — "
                  "the actor's init-time method eligibility table; the "
                  "driver routes gen/unknown methods to the RPC path per "
                  "call without a ring round trip"}},
        "tunnel_attach": {"since": (2, 0), "fields": {
            "lane": "int — raylet-assigned tunnel lane id",
            "kind": "actor | task",
            "->": "{ok, methods?} — actor lanes ship the method "
                  "eligibility table like attach_fast_ring"}},
        "tunnel_records": {"since": (2, 0), "fields": {
            "frames": "[(lane, framed record bytes)] — submit records "
                      "off the node tunnel (notify); replies return as "
                      "tunnel_replies pushes on the same connection"}},
        "tunnel_detach": {"since": (2, 0), "fields": {
            "lanes": "[lane ids] to drop (notify)"}},
        "stream_abandon": {"since": (2, 3), "fields": {
            "task_ids": "[TaskID bytes] — open stream calls whose driver-"
                        "side consumer went away (client disconnect / "
                        "stream aclose): the pump stops flushing chunks "
                        "and closes the user generator (GeneratorExit "
                        "surfaces in its finally) instead of streaming "
                        "to nobody (notify, best-effort)"}},
        "dump_stack": {"since": (1, 3), "fields": {}},
        "heap_profile": {"since": (1, 4), "fields": {
            "action": "start | snapshot | stop (tracemalloc control)",
            "top": "snapshot: top-N allocation sites",
            "nframes": "start: traceback depth"}},
        "cpu_profile": {"since": (1, 5), "fields": {
            "duration_s": "sampling window (capped 30s)",
            "interval_s": "sample period — folded stacks returned"}},
    },
}


def compatible(peer: tuple[int, int]) -> bool:
    """Same major = compatible; minor additions are tolerated both ways."""
    return peer[0] == PROTOCOL_VERSION[0]


def methods(service: str) -> set[str]:
    return set(CATALOG[service])

"""Fast-lane router hop: same-node replica calls over the actor shm rings.

The router's dispatch (`handle.py _call_replica`) is loop-resident, and
the actor fast lane deliberately refuses loop callers — its reply
detours through the migrate queue's linger timer, which is pure added
latency for a coroutine already parked on the loop. This module rides the
loop-side variant instead (``CoreClient.fast_actor_submit_loop``): the
reply thread resolves the router's future DIRECTLY with the raw
(status, payload) tuple, one ``call_soon_threadsafe`` per reply batch.

Semantics are the actor fast lane's, unchanged:

- **per-replica templates**: the packed ``handle_request`` method key and
  lane binding are frozen once per replica (`ReplicaLane`), the serve
  twin of ``ActorCallTemplate``; rebound automatically when the lane
  breaks and reattaches (replica restart).
- **per-CALL RPC fallback**: pending/remote ref args, oversized
  payloads, a missing/broken lane, or FIFO conflicts with queued RPC
  calls route THAT call over the actor RPC plane — the lane survives,
  and the retry/hedge/deadline machinery above sees one code path.
- **cross-node via the node tunnel** (protocol 2.0): rings are
  same-node by design, but a REMOTE replica binds a tunnel lane
  (core/tunnel.py) registered in the same ``_fast_actor_lanes`` table —
  its calls ride coalesced ring-format frames over the per-node-pair
  tunnel (N queued requests in one loop tick ship as ONE frame, the
  proxy-side request coalescing), with payloads above
  ``tunnel_inline_max`` shipped as shm descriptors the replica adopts
  via one batched pull. The routing layer does not need to know which
  transport serves a replica — submit simply returns None where no
  lane (ring or tunnel) exists, and that call takes RPC.
"""
from __future__ import annotations

from ray_tpu_torch.config import get_config


def fastlane_enabled() -> bool:
    """Live read (A/B arms and tests flip ``Config.serve_fastlane``)."""
    return bool(get_config().serve_fastlane)


class ReplicaLane:
    """Frozen per-replica fast-lane submission state for the router.

    One per (router, replica_id), built lazily at the replica's first
    routed request and dropped when the replica leaves the membership
    table. Tracks how many calls rode the ring vs fell back to RPC —
    the router aggregates these into ``lane_stats()`` (tests/bench use
    them to prove the fast lane actually carried traffic).
    """

    __slots__ = ("actor_id", "_tmpl", "fast_calls", "rpc_calls",
                 "traced_calls", "fast_streams", "rpc_streams")

    METHOD = "handle_request"
    STREAM_METHOD = "handle_request_streaming"

    def __init__(self, actor_id):
        self.actor_id = actor_id
        self._tmpl = None
        self.fast_calls = 0
        self.rpc_calls = 0
        # sampled requests whose wire trace leg rode this lane (2.1):
        # the proof the fast lane is no longer trace-invisible
        self.traced_calls = 0
        # streams that rode "G" chunk records vs the per-item ObjectRef
        # fallback (wire 2.3)
        self.fast_streams = 0
        self.rpc_streams = 0

    def submit(self, core, args: tuple):
        """Try the ring: returns ``(task_id, future)`` (decode with
        ``core.fast_actor_await``) or None → RPC path for this call.
        A sampled request's trace context (the router's root/attempt
        span, ambient in the routing coroutine) rides the record's wire
        leg — ``fast_actor_submit_loop`` captures the contextvar itself,
        so trace-on no longer forces these calls onto the RPC plane."""
        tmpl = self._tmpl
        if tmpl is None or tmpl.core is not core:
            tmpl = self._tmpl = core.actor_call_template(
                self.actor_id, self.METHOD, 1, None)
        out = core.fast_actor_submit_loop(
            self.actor_id, self.METHOD, args, {}, tmpl)
        if out is None:
            self.rpc_calls += 1
        else:
            self.fast_calls += 1
            if getattr(core, "_trace_on", False):
                from ray_tpu_torch.utils import tracing

                if tracing.current() is not None:
                    self.traced_calls += 1
        return out

    def submit_stream(self, core, args: tuple):
        """Try the ring for a streaming request: returns
        ``(task_id, sink)`` (consume with ``core.fast_actor_stream``) or
        None → per-item ObjectRef fallback for this stream. Chunks ride
        the same lane as the unary calls — "G" records interleave with
        "A"/"C" replies on the ring/tunnel, ordered by the lane's seq
        machinery, no per-chunk ObjectRef or task event."""
        out = core.fast_actor_submit_stream(
            self.actor_id, self.STREAM_METHOD, args, {})
        if out is None:
            self.rpc_streams += 1
        else:
            self.fast_streams += 1
        return out

    def stats(self) -> dict:
        return {"fast_calls": self.fast_calls, "rpc_calls": self.rpc_calls,
                "traced_calls": self.traced_calls,
                "fast_streams": self.fast_streams,
                "rpc_streams": self.rpc_streams}

    def transport(self, core) -> str:
        """Which plane currently serves this replica: "ring" (same-node
        shm), "tunnel" (cross-node), or "rpc" (no lane)."""
        lane = core._fast_actor_lanes.get(self.actor_id)
        if lane is None or lane.broken or lane.retired:
            return "rpc"
        return "tunnel" if getattr(lane.ring, "tunnel", False) else "ring"

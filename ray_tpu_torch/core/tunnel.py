"""Cross-node fast lane: node tunnels carrying coalesced ring-format frames.

The shm fast lanes (core/fastpath.py) are same-node by design, so every
cross-node actor call, serve route and task push used to drop to per-call
RPC — one pickled spec + frame + loop write per request, exactly the
per-call overhead the local lanes spent four releases deleting. This
module is the cross-node half of the fast path, run the Pathways way
(Barham et al. 2022): a dedicated dataflow plane of persistent per-host
channels that ships descriptors, not payloads.

Topology: ONE persistent, multiplexed connection per node pair — the
driver's :class:`TunnelClient` dials the REMOTE node's raylet lazily and
keeps it (reconnect-with-backoff); the raylet terminates the tunnel and
routes records to its local workers over cached raylet->worker
connections (core/raylet.py ``rpc_tunnel_bind``/``rpc_tunnel_frame``).
Every lane multiplexed over the tunnel binds one remote worker (an actor,
a serve replica's worker, or a leased task worker).

Wire: the tunnel carries the SAME packed records the shm rings use —
``fastpath.pack_actor_task`` "A"/"C" records with per-lane seq numbers,
task "Q"/"R" records, and ``pack_reply`` completion records with stage
stamps and echoed seqs (out-of-order replies are seq-matched exactly like
ring completions). Driver-side, a :class:`TunnelRing` duck-types the
``RingPair`` face so ``FastLane`` — tx coalescing via ``txbuf`` +
adaptive defer + linger backstop, in-flight accounting, break-lane
recovery — is reused verbatim; N queued calls ship as ONE frame. A
second coalescing layer lives here: pushes from any lane landing in the
same loop tick merge into one multi-lane frame per node pair.

Payloads above ``Config.tunnel_inline_max`` do not ride the tunnel: the
sender seals them into its local shm arena and the record carries a
``fastpath.TunnelArgRef`` (node, oid, nbytes) descriptor; the receiver
adopts the whole set via ONE batched ``pull_objects`` round trip.
Results above the inline cap seal into the executing node's arena and the
completion record carries ``pack_shm_desc(size, node)`` — the record IS
the location registration.

Failure model: any tunnel fault (send failure, injected ``rpc.tunnel``
chaos, peer death) breaks every lane on that tunnel — the driver's
ordinary break-lane recovery resubmits tracked in-flight calls over the
per-call RPC path (which stays the source of truth) and surfaces
untracked serve calls as ConnectionLost to the router's retry gate. The
health loop revives lanes once the redial lands.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
import threading
import time

from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import recorder, rpc

log = logging.getLogger(__name__)

# TunnelRing status codes mirror the native ring's (fastpath._ST_*)
_ST_CLOSED = -7


def count_records(framed: bytes) -> int:
    """Number of [u32 len][payload] records in a fastpath frame buffer
    (one u32 walk — no payload copies)."""
    n = 0
    off = 0
    end = len(framed)
    while off + 4 <= end:
        (ln,) = struct.unpack_from("<I", framed, off)
        off += (4 + ln + 7) & ~7
        n += 1
    return n


class TunnelRing:
    """Per-lane ring facade over a node tunnel.

    Duck-types the subset of :class:`fastpath.RingPair` that ``FastLane``
    and the driver's submit/flush machinery touch. Pushes enqueue framed
    record bytes onto the owning tunnel's tx queue (coalesced per loop
    tick); there is no pop side — replies arrive as tunnel frames on the
    connection and feed ``CoreClient._fast_process_replies`` directly, so
    ``pop_batch`` only exists to satisfy teardown paths and returns
    nothing. ``tunnel`` marks the lane so the blocking-get steal path
    (which is a shm-ring optimization) skips it.
    """

    tunnel = True

    __slots__ = ("_t", "lane_id", "_closed", "name")

    def __init__(self, tunnel: "NodeTunnel", lane_id: int):
        self._t = tunnel
        self.lane_id = lane_id
        self._closed = False
        self.name = f"tunnel:{tunnel.addr[0]}:{tunnel.addr[1]}/{lane_id}"

    # --- push side (driver submit path; any thread) ---
    def push_batch(self, which: int, framed: bytes, timeout_ms: int = 0) -> int:
        if self._closed:
            return _ST_CLOSED
        if not self._t.enqueue(self.lane_id, bytes(framed)):
            return _ST_CLOSED
        return len(framed)

    def push_raw(self, which: int, framed: bytes, timeout_ms: int = -1) -> int:
        st = self.push_batch(which, framed, timeout_ms)
        return 0 if st >= 0 else st

    def push(self, which: int, payload: bytes, timeout_ms: int = -1) -> int:
        pad = (-(4 + len(payload))) % 8
        rec = struct.pack("<I", len(payload)) + payload + b"\x00" * pad
        return self.push_raw(which, rec, timeout_ms)

    # --- pop side (replies arrive via the connection, never here) ---
    def pop_batch(self, which: int, timeout_ms: int):
        if self._closed or self._t.down:
            return None
        if timeout_ms > 0:
            time.sleep(min(timeout_ms, 50) / 1000.0)
        return []

    def pending(self, which: int) -> int:
        return 0

    def stats(self, which: int):
        return None

    # --- lifecycle ---
    def close(self, which: int) -> None:
        self.close_pair()

    def is_closed(self, which: int) -> bool:
        return self._closed or self._t.down

    def close_pair(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._t.drop_lane(self.lane_id)

    def unlink(self) -> None:
        pass


class NodeTunnel:
    """Driver-side end of one node-pair tunnel (one per remote raylet
    address). Owns the connection, the lane registry, the tx coalescer
    and the reconnect backoff."""

    def __init__(self, client: "TunnelClient", addr: tuple):
        self.client = client
        self.core = client.core
        self.addr = tuple(addr)
        self.conn: rpc.Connection | None = None
        self.down = False  # no conn AND the last dial failed
        self.lanes: dict[int, object] = {}   # lane_id -> FastLane
        self.rings: dict[int, TunnelRing] = {}
        self._txq: list = []
        self._tx_armed = False
        self._txlock = threading.Lock()
        self._dial_lock: asyncio.Lock | None = None
        self._dial_fails = 0
        self._next_dial = 0.0  # monotonic: backoff gate for redials
        # coalescing counters (bench.py tunnel arm / tests)
        self.tx_frames = 0
        self.tx_records = 0
        self.rx_frames = 0
        self.rx_records = 0

    # ------------------------------------------------------------- connect
    async def ensure_connected(self) -> rpc.Connection | None:
        """Dial lazily with reconnect backoff (loop thread only). None
        while the backoff window of a failed dial is still open."""
        conn = self.conn
        if conn is not None and not conn._closed:
            return conn
        if self._dial_lock is None:
            self._dial_lock = asyncio.Lock()
        async with self._dial_lock:
            conn = self.conn
            if conn is not None and not conn._closed:
                return conn
            now = time.monotonic()
            if now < self._next_dial:
                return None
            try:
                conn = await rpc.connect(*self.addr, timeout=3.0)
            except Exception:
                self._dial_fails += 1
                backoff = min(self.core.cfg.tunnel_reconnect_max_s,
                              0.2 * (2 ** min(self._dial_fails, 6)))
                self._next_dial = time.monotonic() + backoff
                self.down = True
                return None
            conn.on_message = self._on_push
            self.conn = conn
            self.down = False
            self._dial_fails = 0
            return conn

    def register(self, lane_id: int, lane, ring: TunnelRing) -> None:
        self.lanes[lane_id] = lane
        self.rings[lane_id] = ring

    def drop_lane(self, lane_id: int) -> None:
        """A lane closed driver-side: forget it and tell the raylet so
        the worker's lane state is reaped (best effort)."""
        self.lanes.pop(lane_id, None)
        self.rings.pop(lane_id, None)
        conn = self.conn
        if conn is not None and not conn._closed:
            try:
                conn.send_nowait({"k": "n", "m": "tunnel_detach",
                                  "p": {"lanes": [lane_id]}})
            except Exception:
                log.debug("tunnel detach notify failed", exc_info=True)

    # ------------------------------------------------------------ tx path
    def enqueue(self, lane_id: int, framed: bytes) -> bool:
        """Queue one lane's framed records for the next tick's frame
        (any thread). False when the tunnel is unusable right now — the
        caller's lane breaks and the RPC path owns the records."""
        conn = self.conn
        if conn is None or conn._closed:
            return False
        with self._txlock:
            self._txq.append((lane_id, framed))
            arm = not self._tx_armed
            if arm:
                self._tx_armed = True
        if arm:
            loop = self.core.loop
            try:
                if threading.get_ident() == getattr(loop, "_thread_id", None):
                    loop.call_soon(self._drain_tx)
                else:
                    loop.call_soon_threadsafe(self._drain_tx)
            except RuntimeError:
                return False  # loop gone (shutdown)
        return True

    def _drain_tx(self) -> None:
        """Loop-side: ship everything queued since the last pass as ONE
        multi-lane frame — pushes from different lanes landing in the
        same tick coalesce (the proxy-side request coalescing), and a
        lane's own txbuf coalescing already merged its burst upstream.
        Stays armed while traffic flows (call_soon re-pass, the
        _drain_loop_wakes shape); disarms after one empty pass."""
        with self._txlock:
            q = self._txq
            self._txq = []
            if not q:
                self._tx_armed = False
                return
        # merge consecutive same-lane chunks, preserving per-lane order
        frames: list = []
        for lane_id, framed in q:
            if frames and frames[-1][0] == lane_id:
                frames[-1][1].append(framed)
            else:
                frames.append((lane_id, [framed]))
        frames = [(lid, parts[0] if len(parts) == 1 else b"".join(parts))
                  for lid, parts in frames]
        nrec = sum(count_records(f) for _, f in frames)
        nbytes = sum(len(f) for _, f in frames)
        if chaos.ENABLED:
            # "rpc.tunnel" fault point (tx leg). error/drop both surface
            # as a tunnel break: the frame's records are in their lanes'
            # inflight maps, so break-lane recovery resubmits them over
            # the per-call RPC path — the same road a real dead tunnel
            # takes. delay stalls the loop like a congested link.
            try:
                act = chaos.point("rpc.tunnel", dir="tx",
                                  frames=len(frames), records=nrec,
                                  bytes=nbytes)
            except chaos.ChaosError:
                self._tunnel_broke("chaos error (tx)")
                return
            if act is not None and act.kind == "drop":
                self._tunnel_broke("chaos drop (tx)")
                return
        conn = self.conn
        if conn is None or conn._closed:
            self._tunnel_broke("connection lost")
            return
        try:
            conn.send_nowait({"k": "n", "m": "tunnel_frame",
                              "p": {"frames": frames}})
        except Exception:
            self._tunnel_broke("send failed")
            return
        self.tx_frames += 1
        self.tx_records += nrec
        rec_r = recorder.get_recorder()
        if rec_r is not None:
            rec_r.record(b"", recorder.TUNNEL_TX, a0=nrec,
                         a1=nbytes & 0xFFFFFFFF, a2=nbytes >> 32)
        self.core.loop.call_soon(self._drain_tx)  # burst linger

    # ------------------------------------------------------------ rx path
    def _on_push(self, msg: dict):
        m = msg.get("m")
        if m == "tunnel_frame":
            self._on_reply_frames(msg["p"]["frames"])
        elif m == "tunnel_down":
            # the raylet lost a worker (or never knew the lane): break
            # exactly those lanes — per-call RPC fallback takes over
            for lane_id in msg["p"].get("lanes", ()):
                lane = self.lanes.pop(lane_id, None)
                ring = self.rings.pop(lane_id, None)
                if ring is not None:
                    ring._closed = True
                if lane is not None:
                    self.core._fast_break_lane(lane)

    def _on_reply_frames(self, frames) -> None:
        from ray_tpu_torch.core import fastpath

        if chaos.ENABLED:
            try:
                act = chaos.point("rpc.tunnel", dir="rx",
                                  frames=len(frames))
            except chaos.ChaosError:
                self._tunnel_broke("chaos error (rx)")
                return
            if act is not None and act.kind == "drop":
                # dropping replies loses completions: same recovery as a
                # dead tunnel (break-lane resubmits; duplicates are
                # applied exactly once driver-side)
                self._tunnel_broke("chaos drop (rx)")
                return
        rec_r = recorder.get_recorder()
        for lane_id, recs_b in frames:
            lane = self.lanes.get(lane_id)
            if lane is None:
                continue
            recs = fastpath.unframe(recs_b)
            self.rx_frames += 1
            self.rx_records += len(recs)
            if rec_r is not None:
                rec_r.record(b"", recorder.TUNNEL_RX, a0=len(recs),
                             a1=len(recs_b) & 0xFFFFFFFF,
                             a2=len(recs_b) >> 32)
            self.core._fast_process_replies(lane, recs)

    # ------------------------------------------------------------- failure
    def _tunnel_broke(self, reason: str) -> None:
        """Break EVERY lane on this tunnel (loop thread): in-flight
        tracked calls resubmit over RPC, untracked serve calls surface
        ConnectionLost to the router. The next bind (health-loop
        revival) redials with backoff."""
        conn, self.conn = self.conn, None
        self.down = True
        self._dial_fails += 1
        self._next_dial = time.monotonic() + min(
            self.core.cfg.tunnel_reconnect_max_s,
            0.2 * (2 ** min(self._dial_fails, 6)))
        lanes = list(self.lanes.values())
        for ring in self.rings.values():
            ring._closed = True
        self.lanes.clear()
        self.rings.clear()
        with self._txlock:
            self._txq.clear()
            self._tx_armed = False
        log.debug("node tunnel to %s broke: %s (%d lanes)", self.addr,
                  reason, len(lanes))
        for lane in lanes:
            self.core._fast_break_lane(lane)
        if conn is not None:
            self.core._bg.spawn(conn.close(), self.core.loop)

    async def close(self) -> None:
        conn, self.conn = self.conn, None
        self.down = True
        for ring in self.rings.values():
            ring._closed = True
        self.lanes.clear()
        self.rings.clear()
        if conn is not None:
            await conn.close()


class TunnelClient:
    """All of one CoreClient's node tunnels, keyed by remote raylet
    address. Owned by the CoreClient; everything here runs on (or hops
    to) the core event loop."""

    def __init__(self, core):
        self.core = core
        self.tunnels: dict[tuple, NodeTunnel] = {}
        self._bind_ids = itertools.count(1)

    def tunnel_for(self, addr: tuple) -> NodeTunnel:
        addr = tuple(addr)
        t = self.tunnels.get(addr)
        if t is None:
            t = self.tunnels[addr] = NodeTunnel(self, addr)
        return t

    async def bind_lane(self, addr: tuple, kind: str,
                        worker_id: str | None = None,
                        actor_id: str | None = None):
        """Bind one lane over the node tunnel to ``addr`` (loop thread).
        Returns ``(tunnel, lane_id, ring, methods)`` or None when the
        tunnel is down / the raylet refused — the caller stays on the
        RPC path and the health loop retries later."""
        t = self.tunnel_for(addr)
        conn = await t.ensure_connected()
        if conn is None:
            return None
        payload = {"kind": kind}
        if worker_id is not None:
            payload["worker_id"] = worker_id
        if actor_id is not None:
            payload["actor_id"] = actor_id
        try:
            reply = await conn.call("tunnel_bind", payload, timeout=10)
        except Exception:
            if t.conn is conn:
                t._tunnel_broke("bind failed")
            return None
        if not isinstance(reply, dict) or not reply.get("ok"):
            return None
        lane_id = reply["lane"]
        ring = TunnelRing(t, lane_id)
        return t, lane_id, ring, reply.get("methods")

    def stats(self) -> dict:
        """Aggregate coalescing counters (bench.py tunnel arm; the
        coalesced-frame proof in tests): avg_batch == 1.0 means every
        frame carried a single record."""
        tx_f = sum(t.tx_frames for t in self.tunnels.values())
        tx_r = sum(t.tx_records for t in self.tunnels.values())
        return {
            "tunnels": len(self.tunnels),
            "lanes": sum(len(t.lanes) for t in self.tunnels.values()),
            "tx_frames": tx_f,
            "tx_records": tx_r,
            "rx_frames": sum(t.rx_frames for t in self.tunnels.values()),
            "rx_records": sum(t.rx_records for t in self.tunnels.values()),
            "avg_batch": (tx_r / tx_f) if tx_f else 0.0,
        }

    async def close(self) -> None:
        for t in list(self.tunnels.values()):
            try:
                await t.close()
            except Exception:
                log.debug("tunnel close failed", exc_info=True)
        self.tunnels.clear()

"""Steady-state task-submission fast path over native shm rings.

The role of the reference's C++ steady-state submit loop (ref:
src/ray/core_worker/transport/normal_task_submitter.cc:28 lease-cached
PushTask pipelining, core_worker.cc:2500 SubmitTask): once a lease is
cached for a scheduling key, pushing one more task of the same shape and
reading its reply should never touch an event loop, a socket, or a
serialized RPC frame on either side.

Mechanics: at lease grant the driver creates a :class:`RingPair` — one
POSIX shm segment holding two SPSC byte rings (native side:
_native/src/ring.cc) — and tells the worker to attach. Eligible submits
(plain sync function, inline args, single return, default scheduling)
pickle ``(task_id, func_id, args, kwargs)`` into the submit ring straight
from the calling thread; the worker's pump thread pops batches, executes
on the worker's single task-executor thread, and pushes packed results
into the reply ring; a driver reader thread completes blocking ``get()``s
directly and trickles the results onto the event loop for everything else
(memory-store entries, task events, wait()).

The reply lane is the COMPLETION fast lane, mirroring the submit lane's
semantics in the opposite direction: results at or below
``fastpath_inline_result_max`` ride inside the completion record (no
object-store put, no location registration); larger ones seal into the
node's shm arena and the record carries the size, priming the owner's
location cache at completion time. The worker pump merges records that
arrive mid-batch into one reply frame and pushes with partial-push
semantics — whole records land as they fit, and once the ring has stayed
full past ``fastpath_reply_spill_ms`` the remainder spills to the driver
over RPC (``rpc_fast_result``), so a stalled driver can never wedge task
execution.

Anything that doesn't fit — generators, tasks with options, worker death
mid-flight — falls back to the ordinary RPC path, which stays the single
source of truth for scheduling semantics.

Cross-node (protocol 2.0), the SAME packed records ride the node tunnel
(core/tunnel.py): one persistent multiplexed connection per node pair
carries coalesced frames of these records instead of per-call pickled
RPC specs, with ``FastLane`` reused verbatim driver-side — a
:class:`~ray_tpu_torch.core.tunnel.TunnelRing` duck-types the ring face, so
tx coalescing (txbuf + adaptive defer + linger), seq-matched
out-of-order replies and break-lane recovery are one code path for shm
and tunnel lanes. Payloads above ``tunnel_inline_max`` do not ride the
tunnel: see :class:`TunnelArgRef` and :func:`pack_shm_desc`.

Actor lanes (protocol 1.8) ride the same rings with three extras: records
carry a per-lane call sequence number, replies echo it, and completions
may stream back OUT of submission order — async-actor methods execute on
the worker's event loop and reply as each finishes, so ring order is the
per-caller FIFO *dispatch* invariant, not a completion invariant. Calls
the lane cannot carry (a not-yet-local ObjectRef argument, a generator
method, a per-call options override) fall back to the RPC path per CALL:
the driver drains the lane's in-flight records first (FIFO across the
mixed stream) and the lane resumes fast service afterwards.
"""

from __future__ import annotations

import ctypes
import pickle
import struct
import threading

from ray_tpu_torch import _native
from ray_tpu_torch.devtools import chaos
from ray_tpu_torch.utils import serialization

SUB = 0  # driver -> worker (task records)
REP = 1  # worker -> driver (result records)

# pop-side staging buffer size; every record pushed into a ring MUST fit
# here or the consumer can never drain it (rt_ring_pop_batch -> kTooBig)
POP_BUF_BYTES = 1 << 20

# reply status codes
OK = 0        # payload = packed inline value
OK_SHM = 1    # result sealed into the node's shm arena under the return
#               oid; payload = <Q size (primes the owner's location cache
#               at completion time; empty payload = size unknown)
ERR = 2       # payload = pickled TaskError
NEED_SLOW = 3  # func not executable on the fast path: resubmit via RPC
# streaming chunk statuses (wire 2.3): carried by "G" chunk records ONLY
# (pack_chunk) — never by terminal reply records, so the four statuses
# above keep their exact meaning for every non-stream consumer
CHUNK = 4      # payload = one packed yielded item
CHUNK_SHM = 5  # oversized item sealed in the node arena under the
#                chunk's derived oid (return index chunk_seq + 1 of the
#                call's task id — index 0 stays the terminal reply's);
#                payload = pack_shm_size / pack_shm_desc like OK_SHM

_ST_OK = 0
_ST_TIMEOUT = -4
_ST_CLOSED = -7
_ST_TOOBIG = -9

# rt_ring_stats field order (ring.cc RingStats)
RING_STAT_FIELDS = (
    "push_ops", "push_bytes", "push_records", "pop_ops", "pop_bytes",
    "pop_records", "producer_waits", "consumer_waits", "wake_signals",
    "spin_hits", "partial_pushes", "peak_used",
)


class RingClosed(Exception):
    pass


class RingPair:
    """ctypes face of one rt_ring pair (see ring.cc for the protocol).

    Lifecycle safety: any thread may call :meth:`close` (it only flips the
    in-shm closed flags and wakes sleepers), but :meth:`close_pair` unmaps
    the segment — it marks the handle dead, wakes every blocked call, and
    waits for in-flight C calls to drain before the munmap, so no thread
    can touch freed memory."""

    def __init__(self, name: str, handle: int, owner: bool):
        self.name = name
        self._h = handle
        self._owner = owner
        self._lib = _native.get_lib()
        self._popbuf = ctypes.create_string_buffer(POP_BUF_BYTES)
        self._dead = threading.Event()  # close_pair started
        self._inflight = 0
        self._cv = threading.Condition()

    @classmethod
    def create(cls, name: str, cap_each: int) -> "RingPair":
        lib = _native.get_lib()
        h = lib.rt_ring_pair_create(name.encode(), cap_each)
        if not h:
            raise OSError(f"could not create ring shm {name}")
        return cls(name, h, owner=True)

    @classmethod
    def open(cls, name: str) -> "RingPair":
        lib = _native.get_lib()
        h = lib.rt_ring_pair_open(name.encode())
        if not h:
            raise OSError(f"could not open ring shm {name}")
        return cls(name, h, owner=False)

    def _enter(self) -> bool:
        with self._cv:
            if self._dead.is_set():
                return False
            self._inflight += 1
            return True

    def _exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    def push(self, which: int, payload: bytes, timeout_ms: int = -1) -> int:
        """Returns a _ST_* status; never raises on full/closed."""
        if chaos.ENABLED:
            st = _chaos_push(which, len(payload))
            if st:
                return st
        if not self._enter():
            return _ST_CLOSED
        try:
            return self._lib.rt_ring_push(
                self._h, which, payload, len(payload), timeout_ms)
        finally:
            self._exit()

    def push_raw(self, which: int, framed: bytes, timeout_ms: int = -1) -> int:
        if chaos.ENABLED:
            st = _chaos_push(which, len(framed))
            if st:
                return st
        if not self._enter():
            return _ST_CLOSED
        try:
            return self._lib.rt_ring_push_raw(
                self._h, which, framed, len(framed), timeout_ms)
        finally:
            self._exit()

    def push_batch(self, which: int, framed: bytes, timeout_ms: int = 0) -> int:
        """Push as many whole records of a pre-framed buffer as currently
        fit (waiting up to timeout_ms for the first): returns bytes
        consumed (>= 0) or a negative _ST_* status. One lock round and at
        most one consumer wake for the whole batch — the native half of
        the coalesced flush."""
        if chaos.ENABLED:
            st = _chaos_push(which, len(framed))
            if st:
                return 0 if st == _ST_TIMEOUT else st
        if not self._enter():
            return _ST_CLOSED
        try:
            return self._lib.rt_ring_push_batch(
                self._h, which, framed, len(framed), timeout_ms)
        finally:
            self._exit()

    def pop_batch(self, which: int, timeout_ms: int) -> list[bytes] | None:
        """None once closed AND drained; [] on timeout."""
        if not self._enter():
            return None
        try:
            n = self._lib.rt_ring_pop_batch(
                self._h, which,
                ctypes.cast(self._popbuf, ctypes.POINTER(ctypes.c_uint8)),
                len(self._popbuf), timeout_ms)
        finally:
            self._exit()
        if n == _ST_CLOSED or n == _ST_TOOBIG:
            # closed, or a record that can never fit the pop buffer:
            # either way this ring is done — the caller breaks the lane
            # and recovers over RPC
            return None
        if n <= 0:
            return []
        return unframe(self._popbuf.raw[:n])

    def pending(self, which: int) -> int:
        if not self._enter():
            return 0
        try:
            return self._lib.rt_ring_pending(self._h, which)
        finally:
            self._exit()

    def stats(self, which: int) -> dict[str, int] | None:
        """One direction's shared-memory stats block (ring.cc RingStats),
        read straight out of the mapped segment — both sides of the ring
        see identical numbers, so the driver's metrics flush covers the
        worker's half too. None once the pair is dead."""
        if not self._enter():
            return None
        try:
            out = (ctypes.c_uint64 * len(RING_STAT_FIELDS))()
            n = self._lib.rt_ring_stats(
                self._h, which,
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint64)), len(out))
        finally:
            self._exit()
        return {name: int(out[i])
                for i, name in enumerate(RING_STAT_FIELDS[:n])}

    def close(self, which: int) -> None:
        if not self._enter():
            return
        try:
            self._lib.rt_ring_close(self._h, which)
        finally:
            self._exit()

    def is_closed(self, which: int) -> bool:
        if not self._enter():
            return True
        try:
            return bool(self._lib.rt_ring_closed(self._h, which))
        finally:
            self._exit()

    def close_pair(self) -> None:
        with self._cv:
            if self._dead.is_set():
                return
            self._dead.set()
        # wake every blocked call (handle still mapped), then wait for the
        # in-flight count to drain before unmapping
        self._lib.rt_ring_close(self._h, SUB)
        self._lib.rt_ring_close(self._h, REP)
        with self._cv:
            while self._inflight > 0:
                self._cv.wait(1.0)
        self._lib.rt_ring_pair_close(self._h)
        if self._owner:
            self._lib.rt_ring_pair_destroy(self.name.encode())

    def unlink(self) -> None:
        """Remove the shm name now (mapping stays valid until close_pair);
        idempotent, so teardown can't leak /dev/shm entries even if the
        owning reader thread never gets to run again."""
        self._lib.rt_ring_pair_destroy(self.name.encode())


def _chaos_push(which: int, nbytes: int) -> int:
    """Chaos verdict for one ring push ("ring.push" fault point): 0 =
    proceed; drop maps to the ring-full status (caller retries from the
    consumed prefix / spills to RPC), error maps to closed (caller
    breaks the lane and recovers over RPC) — both recoveries the rings
    already promise, now reachable on demand."""
    try:
        act = chaos.point("ring.push", which=which, bytes=nbytes)
    except chaos.ChaosError:
        return _ST_CLOSED  # pushes report status codes, never raise
    if act is not None and act.kind == "drop":
        return _ST_TIMEOUT
    return 0  # duplicate/corrupt are not meaningful for ring pushes


def frame(records: list[bytes]) -> bytes:
    """[u32 len][payload] per record, 8-aligned — rt_ring_push_raw format."""
    parts = []
    for rec in records:
        pad = (-(4 + len(rec))) % 8
        parts.append(struct.pack("<I", len(rec)) + rec + b"\x00" * pad)
    return b"".join(parts)


def frame_one(rec: bytes) -> bytes:
    """frame([rec]) without the list round-trip (submit hot path)."""
    pad = (-(4 + len(rec))) % 8
    return struct.pack("<I", len(rec)) + rec + b"\x00" * pad


def unframe(buf: bytes) -> list[bytes]:
    out = []
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (ln,) = struct.unpack_from("<I", buf, off)
        out.append(buf[off + 4:off + 4 + ln])
        off += (4 + ln + 7) & ~7
    return out


_SIMPLE = (int, float, str, bytes, bool, type(None))


def _simple(x, depth: int = 2) -> bool:
    if isinstance(x, _SIMPLE):
        return True
    if depth:
        if isinstance(x, (list, tuple)):
            return all(_simple(v, depth - 1) for v in x)
        if isinstance(x, dict):
            return all(isinstance(k, _SIMPLE) and _simple(v, depth - 1)
                       for k, v in x.items())
    return False


def pack_task(task_id: bytes, func_id: bytes, args, kwargs,
              t_ns: int = 0, trace: bytes = b"") -> bytes:
    """Two-tier arg encoding. Simple immutables take the C pickler (the
    submission hot path — a Python-level reducer hook here measured ~2x on
    the whole bench); anything else goes through serialization.pack, whose
    rules match the RPC path: functions/classes from __main__ or test
    modules ship by value, tensors devolve to numpy, nested ObjectRefs
    run the borrow protocol. Plain pickle would encode those by reference
    and silently mean something else on the worker.

    ``t_ns`` (protocol 1.7, flight recorder) is the driver's
    ``perf_counter_ns`` at submit: CLOCK_MONOTONIC is system-wide on
    Linux and fast lanes are same-node, so the worker's pop-time minus
    this stamp IS the submit-ring hop. Stamped records use the "Q"/"R"
    prefixes; un-stamped "P"/"S" stay decodable (recorder off).

    ``trace`` (protocol 2.1) is a packed 25-byte trace leg
    (tracing.pack_ctx) riding behind the stamp: its presence is flagged
    by TRACE_BIT in the stamp's top bit (perf_counter_ns can't reach
    bit 63 for ~292 years, so the bit is free), which keeps unsampled
    records byte-identical to 1.7 ones. A traced record always uses the
    stamped prefixes — t_ns=0 still decodes as "no recorder stamp"."""
    if _simple(args) and (not kwargs or _simple(kwargs)):
        body = pickle.dumps((task_id, func_id, args, kwargs), protocol=5)
        if trace:
            return (b"Q" + struct.pack("<Q", t_ns | TRACE_BIT) + trace
                    + body)
        if t_ns:
            return b"Q" + struct.pack("<Q", t_ns) + body
        return b"P" + body
    body = serialization.pack((task_id, func_id, args, kwargs))
    if trace:
        return b"R" + struct.pack("<Q", t_ns | TRACE_BIT) + trace + body
    if t_ns:
        return b"R" + struct.pack("<Q", t_ns) + body
    return b"S" + body


def unpack_task(rec: bytes):
    """-> (task_id, func_id, args, kwargs, t_submit_ns, trace) — t 0
    when the record carries no recorder stamp, trace b"" when it
    carries no trace leg (decode with tracing.unpack_ctx)."""
    kind = rec[:1]
    if kind == b"P":
        return (*pickle.loads(rec[1:]), 0, b"")
    if kind == b"S":
        return (*serialization.unpack(rec[1:]), 0, b"")
    (t_ns,) = struct.unpack_from("<Q", rec, 1)
    off = 9
    trace = b""
    if t_ns & TRACE_BIT:
        t_ns &= ~TRACE_BIT
        trace = rec[off:off + TRACE_LEN]
        off += TRACE_LEN
    if kind == b"Q":
        return (*pickle.loads(rec[off:]), t_ns, trace)
    return (*serialization.unpack(rec[off:]), t_ns, trace)


# reply-status flag bit: a 16-byte stage stamp follows the header
# (protocol 1.7; kept ≤ 16 bytes so inline results stay under the
# fastpath_inline_result_max threshold budget)
STAMPED = 0x100
# reply-status flag bit (protocol 1.8): a 4-byte per-call sequence number
# follows the header (after the stamp when both are present). Actor-lane
# replies echo the seq the submit record carried, so the driver can match
# completions that stream back OUT of submission order (async actors
# reply as each method finishes) while ring order stays the per-caller
# FIFO *dispatch* invariant.
SEQED = 0x200
# reply-status flag bit (protocol 2.1): a 25-byte trace leg
# (tracing.pack_ctx: <16s trace_id><8s span_id><B sampled>) follows the
# header after the stamp/seq legs. Traced replies ECHO the submit
# record's context, so the driver's reply-apply can stamp the wire-level
# call span for untracked (serve fast-lane) calls without a lookup.
TRACED = 0x400
# record-side trace flag (protocol 2.1): bit 63 of the u64 t_submit
# field of "Q"/"R"/"A"/"C" records — set = a 25-byte trace leg follows
# the record header. Mirrored as kRecordTraceCtxBit in rt_wire.h and
# machine-checked by tests/test_wire_schema.py.
TRACE_BIT = 1 << 63
TRACE_LEN = 25  # struct <16s8sB> — tracing._WIRE
_STAMP = struct.Struct("<IIQ")  # ring_ns (sat), deser_ns (sat), exec_ns
_SEQ = struct.Struct("<I")
_AHDR = struct.Struct("<IQ")    # actor record header: seq, t_submit_ns
_U32_MAX = 0xFFFFFFFF


def pack_actor_task(task_id: bytes, mkey: bytes, args, kwargs,
                    t_ns: int, seq: int, trace: bytes = b"") -> bytes:
    """Actor-lane task record (protocol 1.8). Same two-tier arg encoding
    as :func:`pack_task` ("A" = C pickler, "C" = serialization.pack), but
    the header always carries the per-lane call sequence number plus the
    submit stamp (0 when the recorder is off) — the seq is what lets
    async-actor completions stream back out of ring order while the
    driver still accounts each call exactly once. ``trace`` (2.1) rides
    behind the header, flagged by TRACE_BIT exactly like task records."""
    if _simple(args) and (not kwargs or _simple(kwargs)):
        body = pickle.dumps((task_id, mkey, args, kwargs), protocol=5)
        if trace:
            return b"A" + _AHDR.pack(seq, t_ns | TRACE_BIT) + trace + body
        return b"A" + _AHDR.pack(seq, t_ns) + body
    body = serialization.pack((task_id, mkey, args, kwargs))
    if trace:
        return b"C" + _AHDR.pack(seq, t_ns | TRACE_BIT) + trace + body
    return b"C" + _AHDR.pack(seq, t_ns) + body


def unpack_actor_task(rec: bytes):
    """-> (task_id, mkey, args, kwargs, t_submit_ns, seq, trace).
    Pre-1.8 actor records ("P"/"S"/"Q"/"R") decode with seq=None;
    untraced records decode with trace=b""."""
    kind = rec[:1]
    if kind in (b"A", b"C"):
        seq, t_ns = _AHDR.unpack_from(rec, 1)
        off = 13
        trace = b""
        if t_ns & TRACE_BIT:
            t_ns &= ~TRACE_BIT
            trace = rec[off:off + TRACE_LEN]
            off += TRACE_LEN
        if kind == b"A":
            return (*pickle.loads(rec[off:]), t_ns, seq, trace)
        return (*serialization.unpack(rec[off:]), t_ns, seq, trace)
    t = unpack_task(rec)
    return (*t[:5], None, t[5])


def pack_stamp(ring_ns: int, deser_ns: int, exec_ns: int) -> bytes:
    """Worker-side stage stamp: submit-ring hop (pop - t_submit),
    deserialize (pop -> user-function entry, includes function load and
    exec-mutex acquire), and exec (the user function). The reply hop is
    derived driver-side as total - (ring + deser + exec). Fast path
    packs unclamped (every per-task nanosecond counts — see the bench's
    recorder_overhead_us budget); only out-of-range values (a >4.3s
    ring stall, a clock anomaly) pay the clamping retry."""
    try:
        return _STAMP.pack(ring_ns, deser_ns, exec_ns)
    except struct.error:
        return _STAMP.pack(min(max(ring_ns, 0), _U32_MAX),
                           min(max(deser_ns, 0), _U32_MAX),
                           max(exec_ns, 0))


def unpack_stamp(stamp: bytes) -> tuple[int, int, int]:
    return _STAMP.unpack(stamp)


def pack_reply(task_id: bytes, status: int, payload: bytes,
               stamp: bytes = b"", seq: int | None = None,
               trace: bytes = b"") -> bytes:
    if stamp:
        status |= STAMPED
    tail = stamp
    if seq is not None:
        status |= SEQED
        tail += _SEQ.pack(seq)
    if trace:
        status |= TRACED
        tail += trace
    if tail:
        return struct.pack("<16sI", task_id, status) + tail + payload
    return struct.pack("<16sI", task_id, status) + payload


def unpack_reply(rec: bytes):
    """-> (task_id, status, payload, stamp | None, seq | None, trace) —
    trace b"" unless the reply echoes a submit record's trace leg."""
    task_id, status = struct.unpack_from("<16sI", rec)
    off = 20
    stamp = None
    seq = None
    trace = b""
    if status & STAMPED:
        stamp = rec[off:off + 16]
        off += 16
    if status & SEQED:
        (seq,) = _SEQ.unpack_from(rec, off)
        off += 4
    if status & TRACED:
        trace = rec[off:off + TRACE_LEN]
        off += TRACE_LEN
    return (task_id, status & ~(STAMPED | SEQED | TRACED), rec[off:],
            stamp, seq, trace)


_CHDR = struct.Struct("<16sI")  # chunk body header: task_id, status


def pack_chunk(task_id: bytes, status: int, payload: bytes,
               chunk_seq: int, t_ns: int = 0, trace: bytes = b"") -> bytes:
    """Streaming chunk record ("G", wire 2.3): one seq-matched partial
    completion of a stream-called generator method, flushed per yielded
    item. The header is byte-for-byte the "A"/"C" shape —
    ``<u32 chunk_seq><u64 t_emit_ns>`` with the same TRACE_BIT trace leg
    — so the rings and tunnels order chunks with the machinery they
    already have; the seq slot carries the PER-STREAM chunk index
    (monotonic from 0), not the lane call seq. The body is the reply
    shape: ``<16s task_id><u32 status>`` + payload, status CHUNK
    (inline packed item) or CHUNK_SHM (shm size/desc — the item sealed
    under return index chunk_seq + 1 of the call's task id). The
    stream's END is NOT a "G" record: an ordinary :func:`pack_reply`
    terminal (OK + pack_stream_fin / ERR) closes it on the lane's
    normal seq machinery. An unsampled chunk (no trace leg) is
    byte-identical to one packed before tracing existed — the leg costs
    nothing unless the request is sampled."""
    if trace:
        return (b"G" + _AHDR.pack(chunk_seq, t_ns | TRACE_BIT) + trace
                + _CHDR.pack(task_id, status) + payload)
    return (b"G" + _AHDR.pack(chunk_seq, t_ns)
            + _CHDR.pack(task_id, status) + payload)


def unpack_chunk(rec: bytes):
    """-> (task_id, status, payload, chunk_seq, t_emit_ns, trace), or
    None when ``rec`` is not a well-formed "G" record. Callers that
    share a stream with reply records probe with this FIRST and fall
    back to :func:`unpack_reply` — a reply's leading task-id byte may
    collide with 'G', so chunk routing additionally requires the parsed
    task id to match a registered stream (16 random bytes: a stray
    match is ~2^-128)."""
    if rec[:1] != b"G" or len(rec) < 33:
        return None
    chunk_seq, t_ns = _AHDR.unpack_from(rec, 1)
    off = 13
    trace = b""
    if t_ns & TRACE_BIT:
        t_ns &= ~TRACE_BIT
        trace = rec[off:off + TRACE_LEN]
        off += TRACE_LEN
    if len(rec) < off + 20:
        return None
    task_id, status = _CHDR.unpack_from(rec, off)
    return task_id, status, rec[off + 20:], chunk_seq, t_ns, trace


def pack_stream_fin(nchunks: int) -> bytes:
    """Terminal OK payload of a stream call: the total chunk count, so
    the driver's sink can assert every chunk landed (ring + RPC-spill
    interleavings may reorder; the sink reorders by chunk_seq and the
    count closes the stream exactly once)."""
    return _SEQ.pack(nchunks)


def unpack_stream_fin(payload: bytes) -> int | None:
    if len(payload) >= 4:
        return _SEQ.unpack_from(payload)[0]
    return None


def pack_shm_size(size: int) -> bytes:
    """OK_SHM payload: the sealed result's byte size."""
    return struct.pack("<Q", size)


def unpack_shm_size(payload: bytes) -> int | None:
    if len(payload) >= 8:
        return struct.unpack_from("<Q", payload)[0]
    return None


def pack_shm_desc(size: int, node: bytes) -> bytes:
    """OK_SHM payload for CROSS-NODE completions (protocol 2.0, tunnel
    lanes): ``<Q size><16s holder node id>`` — the record itself is the
    location registration, so the owner primes its cache with the node
    that actually sealed the result and the later get() pulls straight
    from it (descriptors, not payloads, ride the tunnel)."""
    return struct.pack("<Q16s", size, node)


def unpack_shm_desc(payload: bytes) -> tuple[int | None, bytes | None]:
    """-> (size, holder node id | None). Plain size payloads (same-node
    shm rings, pre-2.0 records) decode with node None."""
    if len(payload) >= 24:
        size, node = struct.unpack_from("<Q16s", payload)
        return size, node
    if len(payload) >= 8:
        return struct.unpack_from("<Q", payload)[0], None
    return None, None


class TunnelArgRef:
    """Descriptor for one oversized tunnel-record argument (protocol
    2.0): the value was sealed into the SENDER's local shm arena and the
    record carries only ``(oid, owner address, holder node, nbytes)`` —
    the receiver adopts the bytes via one batched ``pull_objects`` round
    trip (core/tunnel.py). The sender pins the minted ref until the
    call's reply lands, so the sealed copy cannot be freed mid-pull."""

    __slots__ = ("oid", "owner", "node", "nbytes")

    def __init__(self, oid: bytes, owner, node: bytes | None, nbytes: int):
        self.oid = oid
        self.owner = tuple(owner) if owner else None
        self.node = node
        self.nbytes = nbytes

    def __reduce__(self):
        return (TunnelArgRef, (self.oid, self.owner, self.node,
                               self.nbytes))

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TunnelArgRef({self.oid.hex()[:12]}, {self.nbytes}B)"


class FastLane:
    """Driver-side state for one leased worker's ring (submission side).

    ``inflight`` maps task_id -> the light lineage tuple
    ``(func_id, args, kwargs, resources, max_retries, name)`` needed to
    rebuild a full spec if the worker dies. Guarded by the CoreClient's
    fast condition variable; the reader thread pops entries as replies
    arrive.
    """

    __slots__ = ("ring", "worker", "key", "inflight", "broken", "reader",
                 "return_armed", "rx_lock", "user_wants", "resume_evt",
                 "retired", "txbuf", "txbytes", "txlock", "seq_counter",
                 "next_seq", "done_seq", "ooo_replies", "drain_evt",
                 "drain_waiters", "methods", "flush_max_records",
                 "flush_max_bytes")

    def __init__(self, ring: RingPair, worker, key):
        self.ring = ring
        self.worker = worker
        self.key = key
        self.inflight: dict = {}
        self.broken = False
        self.reader: threading.Thread | None = None
        self.return_armed = False  # one idle lease-return watcher at a time
        # actor lanes (protocol 1.8): per-lane call sequence — drawn
        # lock-free (itertools.count: next() is GIL-atomic) at submit,
        # echoed in every reply so completions may stream back out of
        # submission order (async actors). done_seq is the highest seq
        # applied; ooo_replies counts replies that arrived below it (the
        # out-of-order evidence, surfaced by
        # CoreClient.fast_actor_lane_stats for tests and the bench);
        # next_seq is the advisory mirror those stats read.
        import itertools

        self.seq_counter = itertools.count()
        self.next_seq = 0
        self.done_seq = -1
        self.ooo_replies = 0
        # RPC-fallback drain barrier: an asyncio.Event (created on the
        # loop at attach) set whenever ``inflight`` empties WHILE a
        # slow-path call waits on it (drain_waiters > 0 — the gate keeps
        # the loop self-pipe wake OFF the pure-ring round trip, where it
        # measured ~25% of the whole sync call). The actor pump awaits
        # the event before dispatching a slow-path call, replacing the
        # old 1ms busy-poll (the RT013 shape).
        self.drain_evt = None
        self.drain_waiters = 0
        # worker-shipped method eligibility table (attach reply, 1.8):
        # name -> (verdict, concurrency_group); None = unknown (pre-1.8
        # worker), in which case the worker-side NEED_SLOW stays the gate
        self.methods = None
        # Coalesced submit flush: framed records buffered here during a
        # burst ride ONE rt_ring_push_batch (one ring lock round + at most
        # one futex wake) instead of a push per record. Every buffered
        # record is already registered in ``inflight``, so break-lane
        # recovery treats buffered and in-ring records identically.
        self.txbuf: list = []
        self.txbytes = 0
        self.txlock = threading.Lock()
        # per-lane coalescing caps: None = the config defaults. Tunnel
        # lanes widen these (a network frame amortizes over far more
        # records than a same-node ring wake does).
        self.flush_max_records = None
        self.flush_max_bytes = None
        # actor lanes: permanent RPC downgrade. Since 1.8 this fires ONLY
        # on a worker-side NEED_SLOW (a method missing from the shipped
        # eligibility table — dynamically added, or a stale table);
        # ineligible ARGUMENTS and ineligible methods the driver can see
        # coming fall back per CALL instead. In-flight records still drain.
        self.retired = False
        # reply-ring consumer election: a blocking get() steals consumption
        # from the sweeper thread (one thread hop fewer per result); the
        # sweeper parks while user_wants is recent.
        self.rx_lock = threading.Lock()
        self.user_wants = 0.0  # monotonic ts of the last stealing get()
        self.resume_evt = threading.Event()

"""Hot-path flight recorder: always-on, bounded-overhead stage telemetry.

The role of the reference's task-event instrumentation kept ALWAYS on
(ref: src/ray/core_worker/task_event_buffer.h per-task status/profile
events, src/ray/stats/metric_defs.cc stats families), built the way
Dapper-style production tracers are: every process keeps one fixed-size
ring of ns-stamped stage events in SHARED MEMORY, writes are a single
index bump + struct pack (no locks, no allocation, no syscalls), and the
expensive parts (percentile aggregation, GCS publishing, chrome-trace
expansion) happen off the hot path on the existing task-event flush
timer.

Clock model: stamps are ``time.perf_counter_ns()`` (CLOCK_MONOTONIC —
system-wide on Linux, so same-node processes' stamps are directly
comparable, which is exactly the fast lane's scope) plus ONE wall-clock
anchor captured at recorder creation; wall times are reconstructed as
``anchor_wall + (t - anchor_perf)`` so a clock step can never produce a
negative duration.

Because the ring lives in shm (a file under the session tree), the
raylet can map a SIGKILLed worker's recorder after death and dump the
victim's last-N events into its death report — the postmortem role of
the reference's worker crash logs, but with ns-resolution stage data.

Overhead budget: the recorder is ON by default and the task hot path
pays one ``record()`` per process per task (driver: one latency sample
at reply-apply; worker: one compact task record at exec end). Each
``record()`` is one ``struct.pack_into`` into the mapped ring plus an
index store — sub-microsecond; ``bench.py`` measures the end-to-end A/B
as ``recorder_overhead_us`` and the budget is < 1µs/task.
"""

from __future__ import annotations

import os
import struct
import time

from ray_tpu_torch.config import get_config

# ------------------------------------------------------------------ stages
# Stage ids cover the fast-lane path submit-template pack -> ring push ->
# worker pop -> deserialize -> exec start/end -> completion push ->
# driver apply. Compact slots (W_TASK / SAMPLE) carry several stage
# durations in one write; events() expands them back into ordered
# per-stage events.
SUBMIT = 1            # driver: task record packed (t0, embedded in the wire record)
RING_PUSH = 2         # driver: one coalesced flush batch pushed (arg0=records)
WORKER_POP = 3        # worker: batch popped from the submit ring (arg0=records)
DESERIALIZE = 4       # worker: record unpacked + function resolved
EXEC_START = 5        # worker: user function entered
EXEC_END = 6          # worker: user function returned (arg: exec ns)
COMPLETION_PUSH = 7   # worker: reply batch pushed (arg0=records)
DRIVER_APPLY = 8      # driver: reply applied to the memory store
W_TASK = 9            # worker compact record: ring/deser/exec deltas, t=exec end
SAMPLE = 10           # driver compact record: full per-task stage breakdown
CHAOS = 11            # chaos fault fired (devtools/chaos): id slot carries
#                       the point name, args (rule, action code, fault seq)
# Sharded object plane (ray_tpu_torch/sharded): per-shard seal/fetch and whole-
# array reshard events; args are (duration_ns clamped u32, nbytes lo,
# nbytes hi) so a postmortem shows which shard op a process died inside.
SHARD_SEAL = 12       # one shard sealed into the local shm arena
SHARD_FETCH = 13      # one shard read (zero-copy local or pulled)
RESHARD = 14          # collective-backed spec redistribute completed
# Disaggregated LLM serving (ray_tpu_torch/llm/disagg): the request's journey
# through the prefill pool, the KV-page plane, and the decode pool; args
# are (duration_ns clamped u32, nbytes lo, nbytes hi) like the sharded
# stages, so a postmortem shows which leg a worker died inside.
PREFILL_QUEUE = 15    # request waited in a prefill worker's wave queue
KV_SHIP = 16          # KV pages sealed to shm (prefill) or adopted (decode)
DECODE_QUEUE = 17     # adopted request waited for a decode ring slot
# Cross-node node tunnel (core/tunnel.py): one event per coalesced frame
# in each direction — args are (records, bytes lo, bytes hi) so a trace
# shows how many ring-format records each tunnel frame carried (the
# coalescing evidence) and a postmortem shows the last frame a process
# shipped/received before dying.
TUNNEL_TX = 18        # driver: one coalesced record frame sent to a peer node
TUNNEL_RX = 19        # driver: one reply record frame received from a peer node
# Memory tiering (PR 18): the disk legs of the object plane; args are
# (duration_ns clamped u32, nbytes lo, nbytes hi) like the other byte-
# moving stages.
SPILL = 20            # arena pages written to a tier-1 spill file
RESTORE = 21          # tier-1 bytes restored into a fresh arena seal

STAGE_NAMES = {
    SUBMIT: "submit", RING_PUSH: "ring_push", WORKER_POP: "worker_pop",
    DESERIALIZE: "deserialize", EXEC_START: "exec_start",
    EXEC_END: "exec_end", COMPLETION_PUSH: "completion_push",
    DRIVER_APPLY: "driver_apply", W_TASK: "w_task", SAMPLE: "sample",
    CHAOS: "chaos", SHARD_SEAL: "shard_seal", SHARD_FETCH: "shard_fetch",
    RESHARD: "reshard", PREFILL_QUEUE: "prefill_queue", KV_SHIP: "kv_ship",
    DECODE_QUEUE: "decode_queue", TUNNEL_TX: "tunnel_tx",
    TUNNEL_RX: "tunnel_rx", SPILL: "spill", RESTORE: "restore",
}

# Reported latency stages (SAMPLE args, ns): both ring hops are covered —
# ring_sub is pack->worker-pop (hop 1, includes any coalescing defer),
# ring_reply is exec-end->driver-apply (hop 2, includes result pack +
# completion push + reply drain).
LATENCY_STAGES = ("ring_sub", "deserialize", "exec", "ring_reply", "total")

# ------------------------------------------------------------------- layout
_MAGIC = 0x52545245_43314100  # "RTREC1\0" + version byte
_HDR = struct.Struct("<QIIQQQ")  # magic, version, cap, write_seq, anchor_perf, anchor_wall
_HDR_SIZE = 64  # header padded to one cache line
_SLOT = struct.Struct("<QQ16sIIIIIII")  # seq, t_ns, tid, stage, a0..a5
_WTASK = struct.Struct("<QQ16sIIIII")   # prefix of _SLOT: a0..a3 only
_SLOT_SIZE = 64
_VERSION = 1
_SEQ_OFF = 16  # byte offset of write_seq within the header


class Recorder:
    """One process's stage-event ring.

    ``path=None`` keeps the ring in an anonymous buffer (driver default);
    a path maps a file so other processes (the raylet's postmortem read)
    can see it after this process dies.
    """

    def __init__(self, cap: int, path: str | None = None):
        cap = max(64, int(cap))
        self.cap = cap
        self.path = path
        size = _HDR_SIZE + cap * _SLOT_SIZE
        if path is None:
            self._mm = None
            self._buf = bytearray(size)
        else:
            import mmap

            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._buf = self._mm
        self.anchor_perf = time.perf_counter_ns()
        self.anchor_wall = time.time_ns()
        _HDR.pack_into(self._buf, 0, _MAGIC, _VERSION, cap, 0,
                       self.anchor_perf, self.anchor_wall)
        self._seq = 0
        # u64 view over the header's write_seq: publishing the cursor per
        # record is one int store, not a struct pack
        self._seqview = memoryview(self._buf)[_SEQ_OFF:_SEQ_OFF + 8].cast("Q")
        self._pack = _SLOT.pack_into  # bound-method lookup off the hot path

    # ------------------------------------------------------------- recording
    def record(self, tid: bytes, stage: int, t_ns: int = 0,
               a0: int = 0, a1: int = 0, a2: int = 0,
               a3: int = 0, a4: int = 0, a5: int = 0) -> None:
        """Append one stage event; lock-free, drop-oldest once the ring
        wraps. One pack_into + one cursor store — args must already fit
        u32 (callers clamp; masking here would tax every hot-path
        write). Writers are effectively serialized (driver: under the
        fast cv; worker: one pump per ring) and each pack_into is one
        GIL-atomic C call; a rare concurrent write can lose one event to
        last-writer-wins but never corrupt a slot."""
        seq = self._seq + 1
        self._seq = seq
        self._pack(self._buf,
                   _HDR_SIZE + (seq % self.cap) * _SLOT_SIZE,
                   seq, t_ns or time.perf_counter_ns(), tid, stage,
                   a0, a1, a2, a3, a4, a5)
        self._seqview[0] = seq

    def record_sample(self, tid: bytes, t_apply_ns: int, ring_ns: int,
                      deser_ns: int, exec_ns: int, reply_ns: int,
                      total_ns: int) -> None:
        """Driver-side compact per-task record (ONE slot for the whole
        stage breakdown; events() expands it)."""
        self.record(tid, SAMPLE, t_apply_ns, min(ring_ns, 0xFFFFFFFF),
                    min(deser_ns, 0xFFFFFFFF),
                    exec_ns & 0xFFFFFFFF, exec_ns >> 32,
                    min(reply_ns, 0xFFFFFFFF), min(total_ns, 0xFFFFFFFF))

    def record_wtask(self, tid: bytes, t_end_ns: int, ring_ns: int,
                     deser_ns: int, exec_ns: int) -> None:
        """Worker-side compact per-task record at exec end — the one
        recorder write on the worker's per-task hot path, so it packs
        directly (no generic record() indirection; ring/deser already
        clamped by the pump). Unwritten arg fields may hold stale bytes
        from a wrapped slot; W_TASK expansion never reads past a3."""
        seq = self._seq + 1
        self._seq = seq
        _WTASK.pack_into(self._buf,
                         _HDR_SIZE + (seq % self.cap) * _SLOT_SIZE,
                         seq, t_end_ns, tid, W_TASK, ring_ns, deser_ns,
                         exec_ns & 0xFFFFFFFF, exec_ns >> 32)
        self._seqview[0] = seq

    # --------------------------------------------------------------- reading
    def wall_ns(self, t_ns: int) -> int:
        return self.anchor_wall + (t_ns - self.anchor_perf)

    def raw_events(self, last: int | None = None) -> list[dict]:
        return _decode(self._buf, last)

    def events(self, last: int | None = None) -> list[dict]:
        """Decoded events oldest-first, with compact W_TASK/SAMPLE slots
        expanded into ordered per-stage events (synthesized timestamps
        walk backwards from the slot's anchor time)."""
        return _expand(self.raw_events(last))

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._seqview.release()
                self._mm.close()
            except (BufferError, ValueError):
                pass
            self._mm = None

    def unlink(self) -> None:
        """Remove the backing file's NAME only — the mapping stays valid,
        so in-flight record() calls on other threads are safe; the pages
        go away when the process exits (same pattern as RingPair.unlink)."""
        if self.path:
            try:
                os.unlink(self.path)
            except OSError:
                pass


# -------------------------------------------------------- postmortem reading
def read_events(path: str, last: int | None = None) -> list[dict]:
    """Read a (possibly dead) process's recorder file: the raylet's
    postmortem path after a worker SIGKILL. Returns expanded events
    oldest-first, [] when the file is missing/garbage (a torn header must
    not sink the death report)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except OSError:
        return []
    try:
        return _expand(_decode(buf, last))
    except Exception:
        return []


def _decode(buf, last: int | None) -> list[dict]:
    if len(buf) < _HDR_SIZE:
        return []
    magic, version, cap, wseq, a_perf, a_wall = _HDR.unpack_from(buf, 0)
    if magic != _MAGIC or cap <= 0 or len(buf) < _HDR_SIZE + cap * _SLOT_SIZE:
        return []
    lo = max(1, wseq - cap + 1)
    if last is not None:
        lo = max(lo, wseq - last + 1)
    out = []
    for seq in range(lo, wseq + 1):
        off = _HDR_SIZE + (seq % cap) * _SLOT_SIZE
        s, t_ns, tid, stage, a0, a1, a2, a3, a4, a5 = _SLOT.unpack_from(buf, off)
        if s != seq:  # torn/unwritten slot (e.g. killed mid-write)
            continue
        out.append({
            "seq": s, "t_ns": t_ns, "wall_ns": a_wall + (t_ns - a_perf),
            "task_id": tid.hex(), "stage": STAGE_NAMES.get(stage, stage),
            "args": (a0, a1, a2, a3, a4, a5),
        })
    return out


def _expand(events: list[dict]) -> list[dict]:
    out: list[dict] = []
    for ev in events:
        a = ev["args"]
        if ev["stage"] == "w_task":
            ring, deser = a[0], a[1]
            exec_ns = a[2] | (a[3] << 32)
            t_end = ev["t_ns"]
            base = dict(task_id=ev["task_id"], seq=ev["seq"])
            anchor = ev["wall_ns"] - t_end
            for stage, t in (("worker_pop", t_end - exec_ns - deser),
                             ("deserialize", t_end - exec_ns),
                             ("exec_start", t_end - exec_ns),
                             ("exec_end", t_end)):
                out.append({**base, "stage": stage, "t_ns": t,
                            "wall_ns": anchor + t,
                            "args": (ring, deser, a[2], a[3], 0, 0)})
        elif ev["stage"] == "sample":
            ring, deser, reply = a[0], a[1], a[4]
            exec_ns = a[2] | (a[3] << 32)
            t_apply = ev["t_ns"]
            t0 = t_apply - reply - exec_ns - deser - ring
            base = dict(task_id=ev["task_id"], seq=ev["seq"])
            anchor = ev["wall_ns"] - t_apply
            for stage, t in (("submit", t0),
                             ("worker_pop", t0 + ring),
                             ("exec_start", t0 + ring + deser),
                             ("exec_end", t0 + ring + deser + exec_ns),
                             ("driver_apply", t_apply)):
                out.append({**base, "stage": stage, "t_ns": t,
                            "wall_ns": anchor + t,
                            "args": a})
        else:
            out.append(ev)
    return out


# ------------------------------------------------------------- latency stats
class StageStats:
    """Driver-side per-task stage accumulator. The hot path stores the
    RAW reply evidence — ``(t0, t_rx, tid, stamp_bytes)`` — as one tuple
    into a fixed ring (one list store, no parsing, no arithmetic);
    stamps are decoded into (ring_sub, deserialize, exec, ring_reply,
    total) durations lazily at flush/query time over bounded windows.
    This is the whole overhead trick: per task O(1) appends, per SECOND
    bounded decoding."""

    __slots__ = ("ring", "cap", "n", "flushed")

    def __init__(self, cap: int):
        self.cap = max(64, int(cap))
        self.ring: list = [None] * self.cap
        self.n = 0
        self.flushed = 0  # samples already fed to histograms

    def add(self, sample: tuple) -> None:
        self.ring[self.n % self.cap] = sample
        self.n += 1

    def _raw(self, lo: int, hi: int) -> list[tuple]:
        return [s for s in (self.ring[k % self.cap] for k in range(lo, hi))
                if s is not None]

    def window(self, limit: int | None = None) -> list[tuple]:
        """DECODED samples (ring_sub, deser, exec, reply, total) ns,
        oldest-first (``limit``: newest N only — flush-time aggregation
        bounds its work with this)."""
        n = self.n
        lo = max(0, n - self.cap)
        if limit is not None:
            lo = max(lo, n - limit)
        return [decode_sample(s) for s in self._raw(lo, n)]

    def new_since_flush(self, limit: int = 128) -> list[tuple]:
        """Decoded samples added since the last call (bounded: at most
        ``limit`` of the newest — histogram feeding is sampled under
        load, the Dapper trade)."""
        fresh = min(self.n - self.flushed, self.cap, limit)
        self.flushed = self.n
        if fresh <= 0:
            return []
        return [decode_sample(s) for s in self._raw(self.n - fresh, self.n)]

    def raw_window(self, limit: int) -> list[tuple]:
        """Newest raw (t0, t_rx, tid, stamp) tuples (timeline samples)."""
        n = self.n
        return self._raw(max(0, n - self.cap, n - limit), n)

    def snapshot(self, anchor_wall: int, anchor_perf: int) -> dict | None:
        """Publishable latency snapshot: per-stage duration lists from
        the retained window, capped at the newest 1024 — this runs on
        the 1Hz flush timer and its cost (decode + list build + pickle)
        must not scale with recorder_events_cap (the CoreClient flush
        attaches the newest raw wall-anchored samples for timeline
        enrichment)."""
        win = self.window(1024)
        if not win:
            return None
        stages = {name: [s[i] for s in win]
                  for i, name in enumerate(LATENCY_STAGES)}
        return {
            "count": self.n,
            "anchor_wall_ns": anchor_wall,
            "anchor_perf_ns": anchor_perf,
            "stages": stages,
        }


def decode_sample(raw: tuple) -> tuple:
    """(t0, t_rx, tid, stamp) -> (ring_sub, deser, exec, reply, total) ns."""
    t0, t_rx, _tid, stamp = raw
    ring_ns, deser_ns, exec_ns = _STAMPF.unpack(stamp)
    total = t_rx - t0 if t_rx > t0 else 0
    reply = total - ring_ns - deser_ns - exec_ns
    return (ring_ns, deser_ns, exec_ns, reply if reply > 0 else 0, total)


# mirror of core/fastpath.py's reply stamp layout (kept here so decode
# has no import cycle): <u32 ring_ns, u32 deser_ns, u64 exec_ns>
_STAMPF = struct.Struct("<IIQ")


def percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


# ------------------------------------------------------- process-level state
_recorder: Recorder | None = None
_stats: StageStats | None = None
_enabled: bool | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = get_config().recorder_enabled
    return _enabled


def set_enabled(on: bool) -> None:
    """Force the recorder on/off in-process (bench A/B)."""
    global _enabled
    _enabled = bool(on)


def init_process_recorder(path: str | None = None) -> Recorder | None:
    """Create (or re-anchor) this process's recorder. Workers pass a file
    path under the session tree so the raylet can read it postmortem;
    the driver keeps an anonymous ring."""
    global _recorder, _stats
    if not enabled():
        return None
    cap = get_config().recorder_events_cap
    try:
        _recorder = Recorder(cap, path)
    except OSError:
        _recorder = Recorder(cap, None)  # unwritable session dir: stay in-memory
    _stats = StageStats(cap)
    return _recorder


def get_recorder() -> Recorder | None:
    """The process recorder, lazily created anonymous when enabled;
    None while disabled (the single hot-path gate)."""
    if not enabled():
        return None
    if _recorder is None:
        init_process_recorder(None)
    return _recorder


def get_stats() -> StageStats | None:
    if not enabled():
        return None
    if _stats is None:
        init_process_recorder(None)
    return _stats


def worker_recorder_path(temp_dir: str, session: str, worker_hex: str) -> str:
    """Shared convention between worker (creates) and raylet (postmortem
    read): the recorder file of one worker process."""
    return os.path.join(temp_dir, f"session_{session}", "rec",
                        f"worker-{worker_hex[:12]}.rec")

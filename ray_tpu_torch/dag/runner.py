"""Worker-side compiled-DAG execution loop.

Counterpart of ``ray_tpu/dag/runner.py``: the per-actor static schedule
executor (ref: compiled_dag_node.py ExecutableTask :481 + the actor's
_execute_until loop). It runs on a dedicated thread inside the actor's
worker process, blocking on native channel conditions (ctypes calls release
the GIL), so the actor's normal RPC surface stays live. Zero per-iteration
task submissions — each iteration is READ(chans) → COMPUTE(method) →
WRITE(chan) straight against shared memory.

Overlap mode (the reference's READ/COMPUTE/WRITE op interleaving, ref:
dag/dag_node_operation.py:14 + dag_operation_future.py): channel READs run
one iteration AHEAD on a prefetch thread and WRITEs drain on a writer
thread, so a stage's blocking input wait + deserialize and its output's
backpressure wait ride UNDER the current compute instead of serializing
with it — the substrate pipeline-parallel serving needs.

The loop's summary holds its iteration count and a ``timeline`` of its
first ``TIMELINE_ITERS`` iterations: per iteration, when its reads
completed and when its compute started and ended (``time.perf_counter``
in the actor's process). In overlap mode the reads of iteration i+1 can
complete before the compute of iteration i ends; sequentially they never
do.
"""

from __future__ import annotations

import queue
import threading
import time

from ray_tpu_torch.dag.channel import ChannelClosed, ShmChannel
from ray_tpu_torch.utils.ids import ObjectID

_CLOSED = object()  # prefetch sentinel: upstream channel closed
TIMELINE_ITERS = 64


def run_dag_loop(worker, schedule: dict) -> dict:
    store = worker.core.store
    chans: dict[bytes, ShmChannel] = {}

    def chan(cid: bytes) -> ShmChannel:
        c = chans.get(cid)
        if c is None:
            c = chans[cid] = ShmChannel(store, ObjectID(cid),
                                        size=schedule.get("chan_size", 8 << 20))
        return c

    tasks = schedule["tasks"]
    if schedule.get("overlap", True):
        return _run_overlapped(worker, tasks, chan, chans)
    return _run_sequential(worker, tasks, chan)


def _exec_task(worker, t, args):
    if t.get("collective"):
        # collective op node: the group's rendezvous synchronizes the
        # members (ref: dag/collective_node.py + aDAG allreduce); NCCL or
        # gloo, as the group was started
        from ray_tpu_torch.collective import collective as col

        fn = getattr(col, t["collective"])
        return fn(args[0], group_name=t["group"])
    method = getattr(worker.actor_instance, t["method"])
    return method(*args)


def _args(t, chan_value, local_vals) -> list:
    args = []
    for kind, v in t["args"]:
        if kind == "chan":
            args.append(chan_value(v))
        elif kind == "local":
            args.append(local_vals[v])
        else:  # static
            args.append(v)
    return args


def _compute(worker, tasks, chan_value, emit) -> None:
    """One iteration's COMPUTE over the schedule; ``emit(cid, value)``
    takes each output bound for a channel."""
    local_vals: dict[int, object] = {}
    for t in tasks:
        out = _exec_task(worker, t, _args(t, chan_value, local_vals))
        local_vals[t["node_index"]] = out
        if t["out_chan"] is not None:
            emit(t["out_chan"], out)


def _run_sequential(worker, tasks, chan) -> dict:
    iterations = 0
    timeline: list = []
    try:
        while True:
            read_cache: dict[bytes, object] = {}  # one read per chan per iter
            read_done = [None]

            def chan_value(cid):
                if cid not in read_cache:
                    read_cache[cid] = chan(cid).read()
                read_done[0] = time.perf_counter()
                return read_cache[cid]

            start = time.perf_counter()
            _compute(worker, tasks, chan_value, lambda cid, out: chan(cid).write(out))
            if iterations < TIMELINE_ITERS:
                # lazy reads: an iteration's last read ends inside its compute
                timeline.append((read_done[0] or start, start, time.perf_counter()))
            iterations += 1
    except ChannelClosed:
        return {"iterations": iterations, "overlap": False, "timeline": timeline}


def _run_overlapped(worker, tasks, chan, chans) -> dict:
    """READ one iteration ahead + WRITE behind, COMPUTE in the middle.

    One prefetch thread walks the schedule's channel reads in order
    (preserving per-channel version order) and stages each iteration's
    read-set in a depth-1 queue; one writer thread drains a depth-1 queue
    of outputs. Depth 1 keeps the end-to-end backpressure contract: at
    most one iteration's values are buffered per stage beyond what the
    depth-1 channels themselves hold."""
    # channel ids each iteration reads, in schedule order (deduped)
    read_ids: list[bytes] = []
    for t in tasks:
        for kind, v in t["args"]:
            if kind == "chan" and v not in read_ids:
                read_ids.append(v)

    reads_q: queue.Queue = queue.Queue(maxsize=1)
    writes_q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()

    def prefetch():
        try:
            while not stop.is_set():
                batch = {cid: chan(cid).read() for cid in read_ids}
                reads_q.put((time.perf_counter(), batch))
        except ChannelClosed:
            reads_q.put(_CLOSED)
        except BaseException as e:  # noqa: BLE001 — surface on compute side
            reads_q.put(e)

    def drain_writes():
        try:
            while True:
                item = writes_q.get()
                if item is None:
                    return
                cid, value = item
                chan(cid).write(value)
        except BaseException as e:  # noqa: BLE001
            write_err.append(e)
            # keep draining so the compute side never deadlocks on put()
            while writes_q.get() is not None:
                pass

    write_err: list = []
    if read_ids:
        threading.Thread(target=prefetch, name="rt-dag-read", daemon=True).start()
    threading.Thread(target=drain_writes, name="rt-dag-write", daemon=True).start()

    iterations = 0
    timeline: list = []
    try:
        while True:
            if read_ids:
                item = reads_q.get()
                if item is _CLOSED:
                    raise ChannelClosed("upstream")
                if isinstance(item, BaseException):
                    raise item
                read_done, batch = item
            else:
                read_done, batch = time.perf_counter(), {}
            if write_err:
                raise write_err[0]
            start = time.perf_counter()
            _compute(worker, tasks, batch.__getitem__,
                     lambda cid, out: writes_q.put((cid, out)))
            if iterations < TIMELINE_ITERS:
                timeline.append((read_done, start, time.perf_counter()))
            iterations += 1
    except ChannelClosed:
        return {"iterations": iterations, "overlap": True, "timeline": timeline}
    finally:
        stop.set()
        # close channels FIRST: unblocks a prefetch thread mid-read and a
        # writer thread stuck on backpressure (the driver's teardown close
        # already does this for the normal path; this covers error exits).
        # Only then enqueue the writer's stop sentinel — the queue may be
        # full until the unblocked writer drains it.
        for c in chans.values():
            try:
                c.close()
            except Exception:  # raylint: disable=RT012 — teardown best-effort: loops observe the closes that DID land
                pass
        # drain the read queue so a prefetch thread blocked in put()
        # (error exits leave staged batches behind) can run, observe the
        # closed channels and exit instead of leaking with its payloads
        for _ in range(3):
            try:
                reads_q.get(timeout=0.2)
            except queue.Empty:
                break
        writes_q.put(None)

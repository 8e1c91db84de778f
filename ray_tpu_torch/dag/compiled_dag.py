"""CompiledDAG: static per-actor schedules over shm channels.

Counterpart of ``ray_tpu/dag/compiled_dag.py`` (ref:
python/ray/dag/compiled_dag_node.py:805 CompiledDAG._get_or_compile :1542,
execute :2536; dag/dag_node_operation.py:14 READ/COMPUTE/WRITE op
schedules). Compilation:

  1. walk the authored graph (topological — DFS postorder),
  2. allocate one native shm channel per cross-process edge
     (num_readers = #consumer processes; same-actor edges pass values
     in-process with no channel),
  3. ship each actor a static schedule [{read chans -> method -> write chan}]
     executed by a long-running loop (worker.rpc_start_dag_loop) — ZERO
     per-iteration task submissions, the reference's whole point,
  4. driver I/O: execute() writes the input channel, result refs read the
     leaf channels.

Cross-node DAGs: a channel's origin cell lives in the producer's node
arena; every remote reader node gets a local mirror cell, fed one push per
version by a raylet forwarder that releases the origin only after all
mirrors accepted — the reference's remote-reader registration
(ref: core_worker.proto:577 RegisterMutableObjectReader,
experimental_mutable_object_provider.cc), with end-to-end depth-1
backpressure preserved across the network.

Each loop's summary (its iteration count and, for the first iterations,
when each one's reads completed and its compute started and ended, on the
actor's clock) is kept in ``loop_results`` after ``teardown``.
"""

from __future__ import annotations

import threading
import time
from typing import Any

from ray_tpu_torch.core import api
from ray_tpu_torch.dag.channel import ShmChannel
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.utils.ids import ObjectID


def _as_bytes(node_id) -> bytes:
    return node_id.binary() if hasattr(node_id, "binary") else bytes(node_id)


class CompiledDAGRef:
    """Future for one execute() iteration (ref: compiled_dag_ref.py:37)."""

    def __init__(self, dag: "CompiledDAG", version: int):
        self._dag = dag
        self._version = version
        self._value = None
        self._done = False

    def get(self, timeout: float | None = None):
        if not self._done:
            self._value = self._dag._read_output(self._version, timeout)
            self._done = True
        return self._value


class CompiledDAGFuture:
    """Awaitable result of one execute_async() iteration (ref:
    compiled_dag_ref.py:154 CompiledDAGFuture). The blocking channel read
    runs in a thread executor, so awaiting never stalls the event loop;
    like the reference, a future may only be awaited once (results must
    drain in execute order)."""

    def __init__(self, dag: "CompiledDAG", version: int):
        self._dag = dag
        self._version = version
        self._awaited = False

    def __await__(self):
        if self._awaited:
            raise RuntimeError(
                "CompiledDAGFuture can only be awaited once")
        self._awaited = True
        import asyncio

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(
            None, self._dag._read_output, self._version, None).__await__()


class CompiledDAG:
    def __init__(self, root: DAGNode, *, buffer_size_bytes: int = 8 << 20,
                 timeout_s: float = 30.0, overlap: bool = True):
        self.root = root
        self.buffer_size = buffer_size_bytes
        self.timeout_s = timeout_s
        self.overlap = overlap  # READ/COMPUTE/WRITE interleave (runner.py)
        self._compiled = False
        self._torn_down = False
        self._exec_version = 0
        self._read_version = 0
        self._read_lock = threading.Lock()
        self._loop_futures: list = []
        self._loop_actors: list[bytes] = []
        #: actor id (hex) -> its loop's summary, filled by teardown()
        self.loop_results: dict[str, dict] = {}
        self._compile()

    # ------------------------------------------------------------- compile
    def _compile(self) -> None:
        core = api.get_core()
        nodes = list(self.root.walk())
        self.input_node = None
        for n in nodes:
            if isinstance(n, InputNode):
                if self.input_node is not None:
                    raise ValueError("compiled DAG supports exactly one InputNode")
                self.input_node = n
        if self.input_node is None:
            raise ValueError("DAG has no InputNode")
        if isinstance(self.root, MultiOutputNode):
            self.leaves = self.root.outputs
            body = [n for n in nodes if isinstance(n, ClassMethodNode)]
        else:
            if not isinstance(self.root, ClassMethodNode):
                raise ValueError("DAG root must be a ClassMethodNode or MultiOutputNode")
            self.leaves = [self.root]
            body = [n for n in nodes if isinstance(n, ClassMethodNode)]
        if not body:
            raise ValueError("DAG has no actor method nodes")

        # consumer processes per producer node ("driver" or actor_id bytes)
        consumers: dict[int, set] = {id(n): set() for n in nodes}
        for n in body:
            akey = n.actor_handle.actor_id.binary()
            for a in n.args:
                if isinstance(a, DAGNode):
                    consumers[id(a)].add(akey)
        for leaf in self.leaves:
            if not isinstance(leaf, ClassMethodNode):
                raise ValueError("DAG outputs must be actor method nodes")
            consumers[id(leaf)].add("driver")

        # locate every participant: actors may live on ANY node — channels
        # get their origin cell on the producer's node and a mirror cell on
        # every remote reader node, fed by a raylet forwarder per version
        # (ref: core_worker.proto:577 RegisterMutableObjectReader,
        # experimental_mutable_object_provider.cc)
        my_node = core.node_id.binary()
        actor_node: dict[bytes, bytes] = {}  # actor_id -> node_id bytes
        for n in body:
            akey = n.actor_handle.actor_id.binary()
            if akey in actor_node:
                continue
            # channels are wired to the actor's NODE, so compile must know
            # real placements — wait briefly for pending creations instead
            # of silently guessing (a wrong guess wires cells to the wrong
            # arena and the loop's first read hangs)
            deadline = time.monotonic() + 30.0
            node_id = None
            while time.monotonic() < deadline:
                info = core._run_sync(
                    core.gcs.call("get_actor",
                                  {"actor_id": n.actor_handle.actor_id})
                )
                if info is None:
                    raise ValueError(
                        f"actor {n.actor_handle.actor_id!r} not found")
                node_id = info.get("node_id")
                if node_id is not None:
                    break
                time.sleep(0.1)
            if node_id is None:
                raise RuntimeError(
                    f"actor {n.actor_handle.actor_id!r} is not placed yet "
                    "(still PENDING_CREATION after 30s); compile after the "
                    "actor is running")
            actor_node[akey] = _as_bytes(node_id)
        # raylet address per node (for mirror creation + forwarder setup)
        cluster = core._run_sync(core.gcs.call("get_cluster", {}))
        node_addr = {_as_bytes(v["node_id"]): tuple(v["address"])
                     for v in cluster}

        def loc(consumer_key) -> bytes:
            return my_node if consumer_key == "driver" else actor_node[consumer_key]

        store = core.store
        if store is None:
            raise RuntimeError(
                "compiled DAGs need a local shm arena (not available in "
                "remote-client mode)")
        self.channels: dict[int, ShmChannel] = {}
        self._remote_cells: list[tuple[tuple, bytes]] = []  # (addr, chan_id)
        node_actor = {id(n): n.actor_handle.actor_id.binary() for n in body}

        def needs_channel(n) -> set:
            """Cross-process consumer set for node n (producers never read
            their own channel: same-actor edges are passed in-process)."""
            owner = node_actor.get(id(n), "driver")
            return {c for c in consumers[id(n)] if c != owner}

        _raylet_call = self._raylet_call

        for n in [self.input_node] + body:
            readers = needs_channel(n)
            if not readers:
                continue
            prod_node = loc(node_actor.get(id(n), "driver"))
            by_node: dict[bytes, int] = {}
            for c in readers:
                by_node[loc(c)] = by_node.get(loc(c), 0) + 1
            remote_nodes = [nid for nid in by_node if nid != prod_node]
            local_readers = by_node.get(prod_node, 0)
            cid = ObjectID.from_random()
            origin_readers = local_readers + (1 if remote_nodes else 0)
            # origin cell on the producer's node
            if prod_node == my_node:
                ch = ShmChannel(store, cid, size=self.buffer_size,
                                num_readers=origin_readers, create=True)
            else:
                core._run_sync(_raylet_call(
                    node_addr[prod_node], "channel_create",
                    {"chan_id": cid.binary(), "size": self.buffer_size,
                     "num_readers": origin_readers}))
                self._remote_cells.append((node_addr[prod_node], cid.binary()))
                ch = ShmChannel(store, cid, size=self.buffer_size,
                                num_readers=by_node.get(my_node, 0) or 1,
                                create=False)
            # mirror cells on every remote reader node + the forwarder
            if remote_nodes:
                for nid in remote_nodes:
                    if nid == my_node:
                        ShmChannel(store, cid, size=self.buffer_size,
                                   num_readers=by_node[nid], create=True)
                    else:
                        core._run_sync(_raylet_call(
                            node_addr[nid], "channel_create",
                            {"chan_id": cid.binary(), "size": self.buffer_size,
                             "num_readers": by_node[nid]}))
                        self._remote_cells.append((node_addr[nid], cid.binary()))
                core._run_sync(_raylet_call(
                    node_addr[prod_node], "channel_register_remote",
                    {"chan_id": cid.binary(),
                     "readers": [list(node_addr[nid]) for nid in remote_nodes]}))
            self.channels[id(n)] = ch

        # build per-actor schedules in topo order
        node_index = {id(n): i for i, n in enumerate(nodes)}
        schedules: dict[bytes, list] = {}
        for n in body:
            akey = node_actor[id(n)]
            args_spec = []
            for a in n.args:
                if isinstance(a, DAGNode):
                    if node_actor.get(id(a)) == akey:
                        args_spec.append(("local", node_index[id(a)]))
                    else:
                        ch = self.channels[id(a)]
                        args_spec.append(("chan", ch.chan_id.binary()))
                else:
                    args_spec.append(("static", a))
            out = self.channels.get(id(n))
            task = {
                "node_index": node_index[id(n)],
                "method": n.method_name,
                "args": args_spec,
                "out_chan": out.chan_id.binary() if out else None,
            }
            if isinstance(n, CollectiveNode):
                task["collective"] = n.op
                task["group"] = n.group_name
            schedules.setdefault(akey, []).append(task)
        for sched in schedules.values():
            sched.sort(key=lambda t: t["node_index"])

        # Overlap safety per actor: the prefetch thread reads ALL of an
        # iteration's channels before any compute, so it deadlocks if one
        # of an actor's channel reads transitively depends on a node the
        # SAME actor executes this iteration (a -> b -> a shapes). Those
        # actors fall back to the lazy sequential schedule.
        deps: dict[int, set] = {}

        def transitive_actors(n) -> set:
            got = deps.get(id(n))
            if got is not None:
                return got
            acc: set = set()
            if id(n) in node_actor:
                acc.add(node_actor[id(n)])
            for a in getattr(n, "args", ()):  # InputNode has no args
                if isinstance(a, DAGNode):
                    acc |= transitive_actors(a)
            deps[id(n)] = acc
            return acc

        overlap_ok: dict[bytes, bool] = {}
        for n in body:
            akey = node_actor[id(n)]
            for a in n.args:
                if (isinstance(a, DAGNode)
                        and node_actor.get(id(a)) != akey
                        and akey in transitive_actors(a)):
                    overlap_ok[akey] = False
            overlap_ok.setdefault(akey, True)

        # start the per-actor loops (long-running RPC; replies on teardown)
        self.input_channel = self.channels[id(self.input_node)]
        self.leaf_channels = [self.channels[id(leaf)] for leaf in self.leaves]
        self._actor_handles = {node_actor[id(n)]: n.actor_handle for n in body}
        for akey, sched in schedules.items():
            handle = self._actor_handles[akey]
            fut = core.start_dag_loop(handle, {
                "tasks": sched,
                "chan_size": self.buffer_size,
                "overlap": self.overlap and overlap_ok.get(akey, True),
            })
            self._loop_futures.append(fut)
            self._loop_actors.append(akey)
        # give loops a beat to attach to channels before first execute
        time.sleep(0.05)
        self._compiled = True

    @staticmethod
    async def _raylet_call(addr, method, payload):
        """One RPC to a raylet, reusing the persistent connection when it's
        the driver's own."""
        core = api.get_core()
        if tuple(addr) == tuple(core.raylet_address):
            return await core.raylet.call(method, payload)
        from ray_tpu_torch.utils import rpc as _rpc

        c = await _rpc.connect(*addr, timeout=10)
        try:
            return await c.call(method, payload, timeout=30)
        finally:
            await c.close()

    # ------------------------------------------------------------- execute
    def execute(self, value: Any) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("DAG was torn down")
        self.input_channel.write(value, timeout_ms=int(self.timeout_s * 1000))
        self._exec_version += 1
        return CompiledDAGRef(self, self._exec_version)

    async def execute_async(self, value: Any) -> CompiledDAGFuture:
        """Async twin of execute() (ref: compiled_dag_node.py:2617
        execute_async): the input write (which can block on channel
        backpressure) runs in a thread executor, and the returned future
        is awaited — not .get()ed — for the result."""
        if self._torn_down:
            raise RuntimeError("DAG was torn down")
        import asyncio

        loop = asyncio.get_event_loop()
        await loop.run_in_executor(
            None, self.input_channel.write, value,
            int(self.timeout_s * 1000))
        self._exec_version += 1
        return CompiledDAGFuture(self, self._exec_version)

    def _read_output(self, version: int, timeout: float | None):
        deadline_ms = int((timeout or self.timeout_s) * 1000)
        with self._read_lock:
            if version != self._read_version + 1:
                raise RuntimeError(
                    "compiled DAG results must be read in execute order "
                    f"(asked v{version}, next is v{self._read_version + 1})"
                )
            vals = [ch.read(timeout_ms=deadline_ms) for ch in self.leaf_channels]
            self._read_version = version
        if isinstance(self.root, MultiOutputNode):
            return vals
        return vals[0]

    # ------------------------------------------------------------ teardown
    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        for ch in self.channels.values():
            try:
                ch.close()
            except Exception:  # raylint: disable=RT012 — teardown best-effort: remaining cells close below
                pass
        core = api.get_core()
        # close origin/mirror cells living on other nodes, concurrently
        # (forwarders see the close and propagate it)
        cells = getattr(self, "_remote_cells", [])
        if cells:
            async def _close_all():
                import asyncio as _a

                await _a.gather(*[
                    self._raylet_call(addr, "channel_close", {"chan_id": cid})
                    for addr, cid in cells
                ], return_exceptions=True)

            try:
                core._run_sync(_close_all())
            except Exception:  # raylint: disable=RT012 — mirror nodes may already be dead
                pass
        # loops observe the close and reply; drain their results
        for akey, fut in zip(self._loop_actors, self._loop_futures):
            try:
                self.loop_results[akey.hex()] = core.wait_dag_loop(fut, timeout=5.0)
            except Exception:  # raylint: disable=RT012 — loop workers may have died with their channels
                pass

    def __del__(self):
        try:
            self.teardown()
        except Exception:  # raylint: disable=RT012 — __del__ may run at interpreter exit
            pass

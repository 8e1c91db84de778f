"""Asyncio RPC substrate for the control plane.

Fills the role of the reference's gRPC scaffolding (ref: src/ray/rpc/
grpc_server.h:88, client_call.h:203): request/response with correlation ids,
one-way notifications, and server-push messages over length-prefixed pickle
frames on TCP. Interfaces are deliberately service-shaped (method-name
dispatch) so a future C++/gRPC data plane can slot in behind the same call
sites.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import random
import struct
import threading
from typing import Any, Awaitable, Callable

from ray_tpu_torch.devtools import chaos

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")


def _chaos_frame(msg: Any, data: bytes):
    """"rpc.send" fault-point verdict for one outbound frame: the
    (possibly corrupted) bytes to write, None to drop the frame on the
    floor, or ``(data, data)`` when the frame must be written twice
    (duplicate). delay sleeps in place (the transport thread stalls —
    a slow/frozen peer link); an `error` action surfaces as
    ConnectionLost, the exact exception a dead transport raises, so the
    injected fault travels the same recovery paths the real one does."""
    try:
        # corruption targets the pickled body, not the length prefix: a
        # mangled prefix would desync the stream into a silent hang,
        # while a mangled body surfaces as a deserialization fault the
        # peer's read loop actually handles
        act = chaos.point(
            "rpc.send", data[_LEN.size:],
            method=msg.get("m") if isinstance(msg, dict) else None,
            kind=msg.get("k") if isinstance(msg, dict) else None)
    except chaos.ChaosError as e:
        raise ConnectionLost(f"chaos: {e}") from e
    if act is None:
        return data
    if act.kind == "drop":
        return None
    if act.kind == "corrupt" and act.payload is not None:
        return data[:_LEN.size] + act.payload
    if act.kind == "duplicate":
        return (data, data)
    return data


def _resolve_multi(pending: dict, items: list):
    """Resolve futures for a coalesced-response ("R") frame:
    items = [(corr_id, value, error)]."""
    for i, v, e in items:
        fut = pending.pop(i, None)
        if fut is not None and not fut.done():
            if e is not None:
                fut.set_exception(e)
            else:
                fut.set_result(v)


class RpcError(Exception):
    pass


class ConnectionLost(RpcError):
    pass


async def read_frame(reader: asyncio.StreamReader) -> Any:
    try:
        header = await reader.readexactly(_LEN.size)
        (n,) = _LEN.unpack(header)
        payload = await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError) as e:
        raise ConnectionLost(str(e)) from None
    return pickle.loads(payload)


def frame_bytes(msg: Any) -> bytes:
    payload = pickle.dumps(msg, protocol=5)
    return _LEN.pack(len(payload)) + payload


class Connection:
    """One bidirectional peer link: concurrent calls, notifications, push."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self.on_message: Callable[[dict], Awaitable[Any] | None] | None = None
        self._reader_task: asyncio.Task | None = None

    @property
    def peername(self):
        try:
            return self.writer.get_extra_info("peername")
        except Exception:
            return None

    def start(self):
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())

    async def _read_loop(self):
        try:
            while True:
                msg = await read_frame(self.reader)
                kind = msg.get("k")
                if kind == "r":  # response
                    fut = self._pending.pop(msg["i"], None)
                    if fut is not None and not fut.done():
                        if msg.get("e") is not None:
                            fut.set_exception(msg["e"])
                        else:
                            fut.set_result(msg.get("v"))
                elif kind == "R":  # coalesced responses (scatter replies)
                    _resolve_multi(self._pending, msg["f"])
                elif self.on_message is not None:
                    res = self.on_message(msg)
                    if asyncio.iscoroutine(res):
                        asyncio.get_running_loop().create_task(res)
        except (ConnectionLost, asyncio.CancelledError, Exception) as e:
            self._fail_pending(e if isinstance(e, Exception) else ConnectionLost("closed"))

    def _fail_pending(self, exc: Exception):
        self._closed = True
        # peer DIED (not a deliberate close): its replacement on this
        # address must re-handshake — a restart can change the wire
        # version, and ephemeral ports get reused
        if not getattr(self, "_closing", False):
            _VERIFIED_PEERS.discard(getattr(self, "_peer_key", None))
        exc = exc if isinstance(exc, ConnectionLost) else ConnectionLost(repr(exc))
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    def send_nowait(self, msg: dict):
        """Write a frame without awaiting backpressure (transport buffers)."""
        if self._closed:
            raise ConnectionLost("connection closed")
        data = frame_bytes(msg)
        if chaos.ENABLED:
            data = _chaos_frame(msg, data)
            if data is None:
                return  # dropped: the peer never sees this frame
            if isinstance(data, tuple):  # duplicated
                for d in data:
                    self.writer.write(d)
                return
        self.writer.write(data)

    async def send(self, msg: dict):
        self.send_nowait(msg)
        # Backpressure: only await when the transport is actually over its
        # high-water mark (drain() is a no-op await otherwise, and skipping
        # it saves a lock + await per frame on the hot path).
        try:
            if self.writer.transport.get_write_buffer_size() > (1 << 21):
                await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError) as e:
            raise ConnectionLost(str(e)) from None

    async def call(self, method: str, payload: Any = None, timeout: float | None = None):
        i = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[i] = fut
        await self.send({"k": "c", "i": i, "m": method, "p": payload})
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def notify(self, method: str, payload: Any = None):
        await self.send({"k": "n", "m": method, "p": payload})

    async def respond(self, msg_id: int, value: Any = None, error: Exception | None = None):
        await self.send({"k": "r", "i": msg_id, "v": value, "e": error})

    async def respond_multi(self, items: list):
        """items: [(msg_id, value, error)] — one frame, many responses."""
        await self.send({"k": "R", "f": items})

    call_scatter = None  # bound below (shared with LoopbackConnection)

    async def close(self):
        self._closed = True
        self._closing = True  # deliberate: keep the peer's handshake cached
        if self._reader_task is not None:
            self._reader_task.cancel()
        try:
            self.writer.close()
            # wait_closed() can hang indefinitely when the reader task was
            # cancelled mid-frame; bound it — the fd is closed either way.
            await asyncio.wait_for(self.writer.wait_closed(), timeout=1.0)
        except (Exception, asyncio.TimeoutError):
            pass


class LoopbackConnection:
    """In-memory Connection pair end for same-process, same-loop peers.

    When the driver runs the GCS/raylet on its own event loop (head mode),
    TCP round-trips per control message are pure syscall overhead. A
    loopback pair delivers frames as loop callbacks instead; messages still
    take a pickle round-trip so payload isolation matches the wire path.
    Duck-types the subset of Connection the control plane uses.
    """

    def __init__(self):
        self.peer: "LoopbackConnection | None" = None
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._closed = False
        self.on_message: Callable[[dict], Awaitable[Any] | None] | None = None
        # set on the server-side end only:
        self._server: "RpcServer | None" = None

    @property
    def peername(self):
        return ("loopback", 0)

    def _deliver(self, msg: dict):
        """Hand a frame to this end, as if read off the socket."""
        if self._closed:
            return
        msg = pickle.loads(pickle.dumps(msg, protocol=5))
        kind = msg.get("k")
        if self._server is not None:
            if kind in ("c", "n"):
                self._server._spawn_dispatch(self, msg)
            elif kind == "r":  # reply to a server-initiated call on this conn
                fut = self._pending.pop(msg["i"], None)
                if fut is not None and not fut.done():
                    if msg.get("e") is not None:
                        fut.set_exception(msg["e"])
                    else:
                        fut.set_result(msg.get("v"))
            elif kind == "R":
                self._apply_multi(msg["f"])
            return
        if kind == "r":
            fut = self._pending.pop(msg["i"], None)
            if fut is not None and not fut.done():
                if msg.get("e") is not None:
                    fut.set_exception(msg["e"])
                else:
                    fut.set_result(msg.get("v"))
        elif kind == "R":
            self._apply_multi(msg["f"])
        elif self.on_message is not None:
            res = self.on_message(msg)
            if asyncio.iscoroutine(res):
                asyncio.get_running_loop().create_task(res)

    def _fail_pending(self, exc: Exception):
        self._closed = True
        exc = exc if isinstance(exc, ConnectionLost) else ConnectionLost(repr(exc))
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    def send_nowait(self, msg: dict):
        if self._closed or self.peer is None:
            raise ConnectionLost("connection closed")
        if chaos.ENABLED:
            # loopback is still "rpc.send": head-mode in-process clusters
            # must see the same drop/duplicate/delay/error faults the
            # wire path does (corrupt has no byte frame here: log-only);
            # error surfaces as ConnectionLost exactly like the wire path
            try:
                act = chaos.point("rpc.send", method=msg.get("m"),
                                  kind=msg.get("k"))
            except chaos.ChaosError as e:
                raise ConnectionLost(f"chaos: {e}") from e
            if act is not None:
                if act.kind == "drop":
                    return
                if act.kind == "duplicate":
                    self.peer._deliver(msg)
        self.peer._deliver(msg)

    async def send(self, msg: dict):
        self.send_nowait(msg)

    async def call(self, method: str, payload: Any = None, timeout: float | None = None):
        i = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[i] = fut
        await self.send({"k": "c", "i": i, "m": method, "p": payload})
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def notify(self, method: str, payload: Any = None):
        await self.send({"k": "n", "m": method, "p": payload})

    async def respond(self, msg_id: int, value: Any = None, error: Exception | None = None):
        await self.send({"k": "r", "i": msg_id, "v": value, "e": error})

    async def respond_multi(self, items: list):
        await self.send({"k": "R", "f": items})

    def _apply_multi(self, items: list):
        _resolve_multi(self._pending, items)

    call_scatter = None  # bound below (shared with Connection)

    async def close(self):
        if self._closed:
            return
        self._fail_pending(ConnectionLost("connection closed"))
        peer = self.peer
        if peer is not None and not peer._closed:
            peer._fail_pending(ConnectionLost("peer disconnected"))
            srv = peer._server
            if srv is not None:
                srv._conns.discard(peer)
                if srv.on_disconnect is not None:
                    try:
                        srv.on_disconnect(peer)
                    except Exception:
                        logger.debug("on_disconnect hook failed",
                                     exc_info=True)


# (host, port) -> (RpcServer, loop) for servers in this process; lets
# rpc.connect() short-circuit same-loop connections through a loopback pair.
_LOCAL_SERVERS: dict[tuple, tuple] = {}

# peers whose version handshake already succeeded this process: a live
# peer's version cannot change, so repeat connects (e.g. per-call owner
# dials) skip the extra round-trip.
_VERIFIED_PEERS: set = set()


def _call_scatter(self, method: str, payloads: list) -> list:
    """Send MANY calls in ONE frame; the handler replies per item (each got
    its own correlation id), so batching the transport does not batch
    completion — a slow task can't hold back its batch-mates' replies.
    Returns one future per payload, resolved like call()'s."""
    loop = asyncio.get_running_loop()
    futs, items = [], []
    for p in payloads:
        i = next(self._ids)
        fut = loop.create_future()
        self._pending[i] = fut
        futs.append(fut)
        items.append((i, p))
    try:
        self.send_nowait({"k": "n", "m": method, "p": {"items": items}})
    except Exception as e:  # ConnectionLost, or an unpicklable payload
        if not isinstance(e, ConnectionLost):
            e = type(e)(str(e))  # detach from the traceback for the futures
        for i, _ in items:
            self._pending.pop(i, None)
        for f in futs:
            if not f.done():
                f.set_exception(e)
    return futs


Connection.call_scatter = _call_scatter
LoopbackConnection.call_scatter = _call_scatter


async def _hello_handler(conn, payload):
    """Version handshake (ref: protobuf schema versioning role — see
    utils/schema.py). Replies with our version; the CLIENT enforces
    compatibility so old peers get a clear error, not a hang."""
    from ray_tpu_torch.utils import schema

    return {"proto": schema.PROTOCOL_VERSION}


class RpcServer:
    """Method-dispatch server. Handlers: async def h(conn, payload) -> value."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._host = host
        self._port = port
        self._server: asyncio.base_events.Server | None = None
        self._handlers: dict[str, Callable] = {"__hello__": _hello_handler}
        self._conns: set[Connection] = set()
        self._dispatch_tasks: set[asyncio.Task] = set()
        self.on_disconnect: Callable[[Connection], None] | None = None

    def route(self, name: str):
        def deco(fn):
            self._handlers[name] = fn
            return fn

        return deco

    def add_routes(self, obj: Any, prefix: str = ""):
        """Register every ``rpc_<name>`` coroutine method of ``obj``."""
        for attr in dir(obj):
            if attr.startswith("rpc_"):
                self._handlers[prefix + attr[4:]] = getattr(obj, attr)

    async def start(self) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._on_client, self._host, self._port)
        sock = self._server.sockets[0]
        self._host, self._port = sock.getsockname()[:2]
        _LOCAL_SERVERS[(self._host, self._port)] = (self, asyncio.get_running_loop())
        return self._host, self._port

    def attach_loopback(self) -> LoopbackConnection:
        """Create an in-memory client connection to this server (same loop)."""
        client = LoopbackConnection()
        server_end = LoopbackConnection()
        server_end._server = self
        client.peer = server_end
        server_end.peer = client
        self._conns.add(server_end)
        return client

    def _spawn_dispatch(self, conn, msg: dict):
        t = asyncio.get_running_loop().create_task(self._dispatch(conn, msg))
        self._dispatch_tasks.add(t)
        t.add_done_callback(self._dispatch_tasks.discard)

    @property
    def address(self) -> tuple[str, int]:
        return self._host, self._port

    async def _on_client(self, reader, writer):
        conn = Connection(reader, writer)
        self._conns.add(conn)
        try:
            while True:
                msg = await read_frame(reader)
                kind = msg.get("k")
                if kind in ("c", "n"):
                    self._spawn_dispatch(conn, msg)
                elif kind == "r":
                    fut = conn._pending.pop(msg["i"], None)
                    if fut is not None and not fut.done():
                        if msg.get("e") is not None:
                            fut.set_exception(msg["e"])
                        else:
                            fut.set_result(msg.get("v"))
                elif kind == "R":
                    _resolve_multi(conn._pending, msg["f"])
        except (ConnectionLost, ConnectionResetError):
            pass
        finally:
            self._conns.discard(conn)
            conn._fail_pending(ConnectionLost("peer disconnected"))
            if self.on_disconnect is not None:
                try:
                    self.on_disconnect(conn)
                except Exception:
                    logger.debug("on_disconnect hook failed", exc_info=True)
            try:
                writer.close()
            except OSError:
                pass

    async def _dispatch(self, conn: Connection, msg: dict):
        handler = self._handlers.get(msg["m"])
        if msg["k"] == "n":
            if handler is not None:
                try:
                    await handler(conn, msg.get("p"))
                except Exception:
                    import traceback

                    traceback.print_exc()
            return
        try:
            if handler is None:
                raise RpcError(f"no handler for {msg['m']!r}")
            value = await handler(conn, msg.get("p"))
            await conn.respond(msg["i"], value=value)
        except ConnectionLost:
            pass
        except Exception as e:
            try:
                await conn.respond(msg["i"], error=e)
            except (ConnectionLost, OSError):
                pass  # caller hung up: nobody is owed this error

    async def stop(self):
        _LOCAL_SERVERS.pop((self._host, self._port), None)
        # close live connections first: their handler coroutines sit in
        # read_frame(), and 3.12's wait_closed() waits for handlers to finish
        for conn in list(self._conns):
            if isinstance(conn, LoopbackConnection):
                conn._closed = True
                if conn.peer is not None:
                    conn.peer._fail_pending(ConnectionLost("server stopped"))
                self._conns.discard(conn)
            else:
                await conn.close()
        for t in list(self._dispatch_tasks):
            t.cancel()
        if self._dispatch_tasks:
            await asyncio.gather(*self._dispatch_tasks, return_exceptions=True)
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2)
            except asyncio.TimeoutError:
                pass


async def connect(host: str, port: int, timeout: float = 30.0,
                  handshake: bool = True) -> Connection:
    local = _LOCAL_SERVERS.get((host, port))
    if local is not None and local[1] is asyncio.get_running_loop():
        return local[0].attach_loopback()  # same process: same version
    deadline = asyncio.get_running_loop().time() + timeout
    last_err: Exception | None = None
    refused = 0
    while asyncio.get_running_loop().time() < deadline:
        try:
            reader, writer = await asyncio.open_connection(host, port)
            conn = Connection(reader, writer)
            conn._peer_key = (host, port)
            conn.start()
            if handshake and (host, port) not in _VERIFIED_PEERS:
                remaining = deadline - asyncio.get_running_loop().time()
                await _check_version(conn, max(1.0, remaining))
                _VERIFIED_PEERS.add((host, port))
                if len(_VERIFIED_PEERS) > 4096:  # port-reuse churn bound
                    _VERIFIED_PEERS.clear()
            return conn
        except (ConnectionRefusedError, OSError) as e:
            last_err = e
            # backoff (capped low: callers are usually waiting on a
            # process that binds within tens of ms) so mass reconnects
            # after a peer restart don't arrive in lockstep
            refused += 1
            await asyncio.sleep(min(0.4, 0.05 * (2 ** (refused - 1)))
                                * (0.5 + random.random()))
    raise ConnectionLost(f"could not connect to {host}:{port}: {last_err}")


async def _check_version(conn: Connection, timeout: float):
    """Enforce wire-schema compatibility (utils/schema.py) at connect time."""
    from ray_tpu_torch.utils import schema

    try:
        reply = await conn.call("__hello__", {"proto": schema.PROTOCOL_VERSION},
                                timeout=timeout)
    except asyncio.TimeoutError:
        await conn.close()
        raise RpcError("peer did not answer the version handshake") from None
    except RpcError as e:
        if "no handler" in str(e):
            # pre-handshake peer: the handshake itself is a 1.x minor
            # addition, so an unknown-method reply means "same major,
            # older minor" — compatible by policy
            return
        await conn.close()
        raise
    peer = tuple(reply.get("proto", (0, 0))) if isinstance(reply, dict) else (0, 0)
    if not schema.compatible(peer):
        await conn.close()
        raise RpcError(
            f"incompatible wire protocol: peer speaks {peer}, "
            f"we speak {schema.PROTOCOL_VERSION}"
        )


class EventLoopThread:
    """A dedicated asyncio loop on a daemon thread; sync<->async bridge.

    The driver-side equivalent of the reference CoreWorker's io_service
    thread — all control-plane sockets live here while the user thread
    blocks in the sync API (ref: core_worker.h:166 io_service_).
    """

    def __init__(self, name: str = "rt-io"):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: float | None = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)


class MuxConnection:
    """Server-side connection face over the native epoll mux
    (_native/src/mux.cc). Duck-types the subset of Connection the control
    plane uses on INCOMING connections: respond/respond_multi/notify/
    send_nowait/close (server-initiated call() always dials a fresh
    client connection, never rides an accepted one)."""

    __slots__ = ("_server", "conn_id", "_pending", "_closed", "_ids",
                 "on_message")

    def __init__(self, server: "NativeRpcServer", conn_id: int):
        self._server = server
        self.conn_id = conn_id
        self._pending: dict[int, asyncio.Future] = {}
        self._ids = itertools.count(1)
        self._closed = False
        self.on_message = None

    @property
    def peername(self):
        return ("mux", self.conn_id)

    def send_nowait(self, msg: dict):
        if self._closed:
            raise ConnectionLost("connection closed")
        data = frame_bytes(msg)
        if chaos.ENABLED:
            data = _chaos_frame(msg, data)
            if data is None:
                return
            if isinstance(data, tuple):
                data = b"".join(data)  # one mux write, both frames
        st = self._server._mux_send(self.conn_id, data)
        if st != 0:
            # a conn we can no longer reply on is DEAD, not just muted:
            # close the socket so the peer observes the disconnect instead
            # of blocking forever on replies that silently stopped (-2 is
            # a >256MB write backlog — a peer that far behind is gone)
            self._closed = True
            self._server._mux_close(self.conn_id)
            raise ConnectionLost(f"mux send failed ({st})")

    async def send(self, msg: dict):
        self.send_nowait(msg)

    async def call(self, method: str, payload: Any = None,
                   timeout: float | None = None):
        i = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[i] = fut
        await self.send({"k": "c", "i": i, "m": method, "p": payload})
        if timeout is None:
            return await fut
        return await asyncio.wait_for(fut, timeout)

    async def notify(self, method: str, payload: Any = None):
        await self.send({"k": "n", "m": method, "p": payload})

    async def respond(self, msg_id: int, value: Any = None,
                      error: Exception | None = None):
        await self.send({"k": "r", "i": msg_id, "v": value, "e": error})

    async def respond_multi(self, items: list):
        await self.send({"k": "R", "f": items})

    call_scatter = _call_scatter

    def _fail_pending(self, exc: Exception):
        self._closed = True
        exc = exc if isinstance(exc, ConnectionLost) else ConnectionLost(repr(exc))
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def close(self):
        if not self._closed:
            self._closed = True
            self._server._mux_close(self.conn_id)


class NativeRpcServer(RpcServer):
    """RpcServer over the native epoll mux (ref: grpc_server.h:88 — the
    completion-queue-threads role). The C++ thread owns every socket and
    frames every message; this loop wakes ONCE per burst via eventfd and
    drains the whole batch in one callback — no per-connection reader
    coroutine, no per-frame Task for the transport."""

    _RECV_BUF0 = 1 << 20

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self._mux = None
        self._efd = -1
        self._muxconns: dict[int, MuxConnection] = {}
        self._recvbuf = None
        self._loop: asyncio.AbstractEventLoop | None = None

    async def start(self) -> tuple[str, int]:
        import ctypes
        import socket

        try:
            from ray_tpu_torch import _native

            lib = _native.get_lib()
            # mux.cc binds with inet_addr (numeric only): resolve names
            # here — 'localhost' would otherwise parse as INADDR_NONE and
            # bind to 255.255.255.255
            host = self._host
            try:
                host = socket.gethostbyname(host)
            except OSError:
                pass  # let the native bind reject it -> asyncio fallback
            out_port = ctypes.c_uint16(0)
            out_efd = ctypes.c_int(-1)
            h = lib.rt_mux_create(host.encode(), self._port,
                                  ctypes.byref(out_port),
                                  ctypes.byref(out_efd))
            if not h:
                raise OSError(
                    f"rt_mux_create failed on {host}:{self._port}")
        except Exception:
            # degrade to the asyncio transport (identical dispatch
            # surface) instead of aborting GCS/raylet startup — a host
            # string or environment that worked under start_server must
            # keep working when the native mux can't come up
            return await super().start()
        self._lib = lib
        self._host = host
        self._mux = h
        self._efd = out_efd.value
        self._port = out_port.value
        self._recvbuf = ctypes.create_string_buffer(self._RECV_BUF0)
        self._loop = asyncio.get_running_loop()
        self._loop.add_reader(self._efd, self._drain)
        _LOCAL_SERVERS[(self._host, self._port)] = (self, self._loop)
        return self._host, self._port

    def _mux_send(self, conn_id: int, framed: bytes) -> int:
        return self._lib.rt_mux_send(self._mux, conn_id, framed, len(framed))

    def _mux_close(self, conn_id: int):
        self._lib.rt_mux_close_conn(self._mux, conn_id)

    def _drain(self):
        import ctypes
        import struct as _s

        if self._mux is None:
            return
        n = self._lib.rt_mux_recv_batch(
            self._mux,
            ctypes.cast(self._recvbuf, ctypes.POINTER(ctypes.c_uint8)),
            len(self._recvbuf))
        if n < 0:  # one record larger than the buffer: grow and retry
            self._recvbuf = ctypes.create_string_buffer(
                max(-n, len(self._recvbuf) * 2))
            return  # eventfd re-signaled; the loop calls us again
        if n == 0:
            return
        buf = self._recvbuf.raw[:n]
        off = 0
        while off + 16 <= n:
            conn_id, rtype, ln = _s.unpack_from("<QII", buf, off)
            payload = buf[off + 16: off + 16 + ln]
            off += 16 + ln
            if rtype == 1:  # connected
                conn = MuxConnection(self, conn_id)
                self._muxconns[conn_id] = conn
                self._conns.add(conn)
                continue
            conn = self._muxconns.get(conn_id)
            if conn is None:
                continue
            if rtype == 2:  # disconnected
                self._muxconns.pop(conn_id, None)
                self._conns.discard(conn)
                conn._fail_pending(ConnectionLost("peer disconnected"))
                if self.on_disconnect is not None:
                    try:
                        self.on_disconnect(conn)
                    except Exception:
                        logger.debug("on_disconnect hook failed",
                                     exc_info=True)
                self._lib.rt_mux_release(self._mux, conn_id)
                continue
            try:
                msg = pickle.loads(payload)
            except Exception:
                continue  # garbage frame: drop it, keep the connection
            kind = msg.get("k")
            if kind in ("c", "n"):
                self._spawn_dispatch(conn, msg)
            elif kind == "r":
                fut = conn._pending.pop(msg["i"], None)
                if fut is not None and not fut.done():
                    if msg.get("e") is not None:
                        fut.set_exception(msg["e"])
                    else:
                        fut.set_result(msg.get("v"))
            elif kind == "R":
                _resolve_multi(conn._pending, msg["f"])

    async def stop(self):
        if self._mux is None and self._server is not None:
            # start() degraded to the asyncio transport: its stop path
            # owns the listener socket and stream connections
            await super().stop()
            return
        _LOCAL_SERVERS.pop((self._host, self._port), None)
        if self._loop is not None and self._efd >= 0:
            try:
                self._loop.remove_reader(self._efd)
            except (OSError, ValueError, RuntimeError):
                pass  # loop already closed / fd already unregistered
        for conn in list(self._conns):
            if isinstance(conn, LoopbackConnection):
                conn._closed = True
                if conn.peer is not None:
                    conn.peer._fail_pending(ConnectionLost("server stopped"))
            elif isinstance(conn, MuxConnection):
                conn._fail_pending(ConnectionLost("server stopped"))
        self._conns.clear()
        self._muxconns.clear()
        for t in list(self._dispatch_tasks):
            t.cancel()
        if self._dispatch_tasks:
            await asyncio.gather(*self._dispatch_tasks, return_exceptions=True)
        if self._mux is not None:
            # rt_mux_stop joins the epoll thread; cheap enough to inline
            self._lib.rt_mux_stop(self._mux)
            self._mux = None


def make_server(host: str = "127.0.0.1", port: int = 0) -> RpcServer:
    """Control-plane server factory: the native mux when enabled, the
    host has cores to run its IO thread CONCURRENTLY with Python
    (native_mux_min_cpus — on a 1-core host the thread only preempts the
    interpreter), and the build succeeds; else the asyncio server
    (identical dispatch surface). RT_NATIVE_MUX_MIN_CPUS=1 forces it on."""
    import os as _os

    from ray_tpu_torch.config import get_config

    cfg = get_config()
    if (cfg.native_mux_enabled
            and (_os.cpu_count() or 1) >= cfg.native_mux_min_cpus):
        try:
            from ray_tpu_torch import _native

            _native.get_lib()  # force the build before committing to it
            return NativeRpcServer(host, port)
        except Exception:
            logger.debug("native mux unavailable; asyncio transport",
                         exc_info=True)
    return RpcServer(host, port)

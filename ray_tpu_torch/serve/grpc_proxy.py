"""gRPC ingress proxy for ray_tpu_torch.serve.

Equivalent of the reference gRPCProxy (ref:
python/ray/serve/_private/proxy.py:530 + grpc_util.py RayServeAPIService)
— a second ingress speaking gRPC next to the HTTP one, sharing the same
DeploymentHandle/router path. The service is schemaless (bytes in/bytes
out with pickled payloads) so no protoc step is needed; the method
surface mirrors the reference's RayServeAPIService:

    /rayserve.ServeAPI/Healthz       b"" -> b"ok"
    /rayserve.ServeAPI/ListApplications  b"" -> pickle({app: [deployments]})
    /rayserve.ServeAPI/Call          pickle(request dict) -> pickle(reply)
    /rayserve.ServeAPI/CallStream    pickle(request dict) -> stream of
                                     pickle({"chunk": ...}) frames
                                     (server-streaming; one frame per
                                     "G" chunk record off the wire)

        request: {"app": str, "deployment": str, "method": str (opt),
                  "args": tuple, "kwargs": dict,
                  "multiplexed_model_id": str (opt)}
        reply:   {"result": ...} | {"error": str, "status": int}

Use :class:`GrpcIngressClient` (any grpc channel works — the wire format
is plain gRPC with bytes serializers).
"""

from __future__ import annotations

import pickle

PROXY_NAME = "SERVE::grpc_proxy"
SERVICE = "rayserve.ServeAPI"


class GrpcProxy:
    """Async actor hosting the grpc.aio ingress server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server = None

    async def ready(self) -> tuple[str, int]:
        if self._server is not None:
            return (self.host, self.port)
        import grpc

        handlers = {
            "Healthz": self._healthz,
            "ListApplications": self._list_applications,
            "Call": self._call,
            "CallStream": self._call_stream,
        }
        streaming = {"CallStream"}

        class _Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                prefix = f"/{SERVICE}/"
                if not call_details.method.startswith(prefix):
                    return None
                name = call_details.method[len(prefix):]
                fn = handlers.get(name)
                if fn is None:
                    return None
                if name in streaming:
                    return grpc.unary_stream_rpc_method_handler(
                        fn, request_deserializer=None,
                        response_serializer=None)
                return grpc.unary_unary_rpc_method_handler(
                    fn, request_deserializer=None,
                    response_serializer=None)

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_Handler(),))
        bound = self._server.add_insecure_port(f"{self.host}:{self.port}")
        self.port = bound
        await self._server.start()
        return (self.host, self.port)

    async def _healthz(self, request: bytes, context) -> bytes:
        return b"ok"

    async def _list_applications(self, request: bytes, context) -> bytes:
        from ray_tpu_torch.core.api import get_core
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        core = get_core()
        controller = await core.get_actor_by_name_async(CONTROLLER_NAME)
        if controller is None:
            return pickle.dumps({})
        ref = controller.get_status.remote()
        (status,) = await core.get_async([ref], 10.0)
        return pickle.dumps({app: list(deps) for app, deps in status.items()})

    async def _call(self, request: bytes, context) -> bytes:
        import grpc

        from ray_tpu_torch.serve.handle import DeploymentHandle, RayServeException
        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )

        try:
            req = pickle.loads(request)
            handle = DeploymentHandle(
                req["deployment"], app_name=req.get("app", "default"),
                multiplexed_model_id=req.get("multiplexed_model_id", ""))
            result = await handle._invoke(
                req.get("method") or "__call__",
                tuple(req.get("args", ())), dict(req.get("kwargs", {})))
            return pickle.dumps({"result": result})
        except BackPressureError as e:
            # overload maps to the canonical gRPC code; retry-after rides
            # the trailing metadata for clients that honor it
            context.set_code(grpc.StatusCode.RESOURCE_EXHAUSTED)
            context.set_details(str(e))
            context.set_trailing_metadata((
                ("retry-after",
                 f"{getattr(e, 'retry_after_s', 1.0):.3f}"),))
            return pickle.dumps({"error": str(e), "status": 429})
        except RequestTimeoutError as e:
            context.set_code(grpc.StatusCode.DEADLINE_EXCEEDED)
            context.set_details(str(e))
            return pickle.dumps({"error": str(e), "status": 504})
        except RayServeException as e:
            return pickle.dumps({"error": str(e), "status": 503})
        except Exception as e:  # noqa: BLE001 — ingress must answer
            return pickle.dumps({"error": str(e), "status": 500})

    async def _call_stream(self, request: bytes, context):
        """Server-streaming leg of :meth:`_call`: one response frame per
        chunk the deployment generator yields. Pre-first-chunk failures
        map to the same canonical codes as Call; after the first frame
        an error becomes a terminal ``{"error": ..., "chunks": n}``
        frame (chunks already on the wire are never replayed). A client
        cancel surfaces here as CancelledError, which closes the
        ServeStream — mid-stream disconnect frees the replica's decode
        slot before the generation would have finished."""
        import grpc

        from ray_tpu_torch.serve.handle import DeploymentHandle, RayServeException
        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )

        n = 0
        try:
            req = pickle.loads(request)
            handle = DeploymentHandle(
                req["deployment"], app_name=req.get("app", "default"),
                multiplexed_model_id=req.get("multiplexed_model_id", ""))
            stream = handle._stream(
                req.get("method") or "__call__",
                tuple(req.get("args", ())), dict(req.get("kwargs", {})))
            try:
                async for chunk in stream:
                    n += 1
                    yield pickle.dumps({"chunk": chunk})
            finally:
                await stream.aclose()
        except BackPressureError as e:
            context.set_code(grpc.StatusCode.RESOURCE_EXHAUSTED)
            context.set_details(str(e))
            context.set_trailing_metadata((
                ("retry-after",
                 f"{getattr(e, 'retry_after_s', 1.0):.3f}"),))
            yield pickle.dumps({"error": str(e), "status": 429, "chunks": n})
        except RequestTimeoutError as e:
            context.set_code(grpc.StatusCode.DEADLINE_EXCEEDED)
            context.set_details(str(e))
            yield pickle.dumps({"error": str(e), "status": 504, "chunks": n})
        except RayServeException as e:
            yield pickle.dumps({"error": str(e), "status": 503, "chunks": n})
        except Exception as e:  # noqa: BLE001 — ingress must answer
            yield pickle.dumps({"error": str(e), "status": 500, "chunks": n})

    async def shutdown(self) -> bool:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
        return True


class GrpcIngressClient:
    """Minimal sync client for the ingress (tests / SDKs)."""

    def __init__(self, host: str, port: int):
        import grpc

        self._channel = grpc.insecure_channel(f"{host}:{port}")

    def _unary(self, method: str, payload: bytes) -> bytes:
        fn = self._channel.unary_unary(f"/{SERVICE}/{method}")
        return fn(payload, timeout=60)

    def healthz(self) -> bool:
        return self._unary("Healthz", b"") == b"ok"

    def list_applications(self) -> dict:
        return pickle.loads(self._unary("ListApplications", b""))

    def call(self, deployment: str, *args, app: str = "default",
             method: str = "", multiplexed_model_id: str = "", **kwargs):
        import grpc

        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )

        try:
            reply = pickle.loads(self._unary("Call", pickle.dumps({
                "app": app, "deployment": deployment, "method": method,
                "args": args, "kwargs": kwargs,
                "multiplexed_model_id": multiplexed_model_id,
            })))
        except grpc.RpcError as e:
            # non-OK statuses come back as RpcError with the canonical
            # code; translate the FT codes to the typed serve errors so
            # SDK callers see the same taxonomy native handles raise
            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                retry_after = 0.1
                try:
                    trailers = dict(e.trailing_metadata() or ())
                    retry_after = float(trailers.get("retry-after",
                                                     retry_after))
                except (TypeError, ValueError):
                    pass  # malformed trailer: keep the default hint
                raise BackPressureError(
                    e.details() or "overloaded",
                    retry_after_s=retry_after) from None
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise RequestTimeoutError(
                    e.details() or "deadline exceeded") from None
            raise
        if "error" in reply:
            raise RuntimeError(f"serve error {reply.get('status')}: "
                               f"{reply['error']}")
        return reply["result"]

    def call_stream(self, deployment: str, *args, app: str = "default",
                    method: str = "", multiplexed_model_id: str = "",
                    timeout: float = 300.0, **kwargs):
        """Generator of chunk values from a streaming deployment method.
        Closing the generator mid-stream cancels the RPC — the server
        handler sees CancelledError and the replica's decode slot frees
        before the generation finishes. Typed serve errors re-raise with
        the same taxonomy as :meth:`call`."""
        import grpc

        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )

        fn = self._channel.unary_stream(f"/{SERVICE}/CallStream")
        call = fn(pickle.dumps({
            "app": app, "deployment": deployment, "method": method,
            "args": args, "kwargs": kwargs,
            "multiplexed_model_id": multiplexed_model_id,
        }), timeout=timeout)
        try:
            for frame in call:
                reply = pickle.loads(frame)
                if "error" in reply:
                    raise RuntimeError(
                        f"serve error {reply.get('status')}: "
                        f"{reply['error']}")
                yield reply["chunk"]
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                retry_after = 0.1
                try:
                    trailers = dict(e.trailing_metadata() or ())
                    retry_after = float(trailers.get("retry-after",
                                                     retry_after))
                except (TypeError, ValueError):
                    pass  # malformed trailer: keep the default hint
                raise BackPressureError(
                    e.details() or "overloaded",
                    retry_after_s=retry_after) from None
            if e.code() == grpc.StatusCode.DEADLINE_EXCEEDED:
                raise RequestTimeoutError(
                    e.details() or "deadline exceeded") from None
            raise
        finally:
            call.cancel()  # no-op if complete; mid-stream: propagates

    def close(self):
        self._channel.close()


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
    """Start (or find) the gRPC proxy actor; returns its bound address."""
    import ray_tpu_torch
    from ray_tpu_torch.core.api import remote

    handle = ray_tpu_torch.get_core().get_actor_by_name(PROXY_NAME)
    if handle is None:
        handle = (
            remote(GrpcProxy)
            .options(name=PROXY_NAME, get_if_exists=True, num_cpus=0.1)
            .remote(host, port)
        )
    return tuple(ray_tpu_torch.get(handle.ready.remote(), timeout=30))

"""HTTP ingress proxy for ray_tpu_torch.serve.

Equivalent of the reference ProxyActor / HTTPProxy (ref:
python/ray/serve/_private/proxy.py:1137, HTTPProxy :750 — uvicorn/
starlette there, aiohttp here since it ships in this image). One async
actor runs an aiohttp server; requests route through the same
DeploymentHandle/router path as native handle calls:

    POST /{app}/{deployment}        body = JSON args -> __call__(body)
    POST /{app}/{deployment}/{m}    -> method m(body)
    GET  /-/healthz                 liveness
    GET  /-/routes                  routing table
"""
from __future__ import annotations

import asyncio

PROXY_NAME = "SERVE::http_proxy"


class HttpProxy:
    """Async actor hosting the aiohttp ingress."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._runner = None
        self._started = False

    async def ready(self) -> tuple[str, int]:
        """Start the server (idempotent); returns the bound address."""
        if self._started:
            return (self.host, self.port)
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/-/healthz", self._healthz)
        app.router.add_get("/-/routes", self._routes)
        app.router.add_route("*", "/{app}/{deployment}", self._handle)
        app.router.add_route("*", "/{app}/{deployment}/{method}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            self.port = self._runner.addresses[0][1]
        self._started = True
        return (self.host, self.port)

    async def _healthz(self, request):
        from aiohttp import web

        return web.json_response({"status": "ok"})

    async def _routes(self, request):
        # loop-safe status: the proxy runs ON the core loop, so the sync
        # serve.status() path (_run_sync) is off-limits here
        from aiohttp import web

        from ray_tpu_torch.core.api import get_core
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        core = get_core()
        controller = await core.get_actor_by_name_async(CONTROLLER_NAME)
        if controller is None:
            return web.json_response({})
        ref = controller.get_status.remote()
        (status,) = await core.get_async([ref], 10.0)
        return web.json_response({app: list(deps) for app, deps in status.items()})

    async def _handle(self, request):
        import math

        from aiohttp import web

        from ray_tpu_torch.serve.handle import DeploymentHandle, RayServeException
        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )

        app_name = request.match_info["app"]
        deployment = request.match_info["deployment"]
        method = request.match_info.get("method") or "__call__"
        if request.can_read_body:
            try:
                body = await request.json()
            except Exception:
                body = (await request.read()).decode()
        else:
            body = None
        handle = DeploymentHandle(deployment, app_name=app_name)
        args = (body,) if body is not None else ()
        if ("text/event-stream" in request.headers.get("Accept", "")
                or request.query.get("stream", "") in ("1", "true")):
            return await self._handle_sse(request, handle, method, args)
        try:
            result = await handle._invoke(method, args, {})
            return web.json_response({"result": result})
        except BackPressureError as e:
            # admission refused (replica or router queue cap): the
            # standard overload answer — 429 + a Retry-After hint sized
            # from the refusing replica's queue depth
            return web.json_response(
                {"error": str(e)}, status=429,
                headers={"Retry-After":
                         str(max(1, math.ceil(
                             getattr(e, "retry_after_s", 1.0))))})
        except RequestTimeoutError as e:
            return web.json_response({"error": str(e)}, status=504)
        except RayServeException as e:
            return web.json_response({"error": str(e)}, status=503)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)

    async def _handle_sse(self, request, handle, method: str, args: tuple):
        """Server-Sent-Events leg of :meth:`_handle` (``Accept:
        text/event-stream`` or ``?stream=1``). Each chunk the deployment
        generator yields — one "G" record on the wire — becomes one SSE
        ``data:`` frame; the stream ends with ``data: [DONE]``. Errors
        raised before the first chunk keep their unary status codes
        (429/504/503/500); once the 200 header is out they become a
        terminal ``event: error`` frame instead. A client disconnect
        surfaces as a failed write, and closing the ServeStream in the
        ``finally`` cancels the replica-side generator — the decode slot
        frees at the next block boundary, not at end of generation."""
        import math

        from aiohttp import web

        from ray_tpu_torch.serve.handle import RayServeException
        from ray_tpu_torch.serve.exceptions import (
            BackPressureError,
            RequestTimeoutError,
        )
        from ray_tpu_torch.serve.streaming import SSE_DONE, sse_event

        stream = handle._stream(method, args, {})
        resp = None
        try:
            try:
                async for chunk in stream:
                    if resp is None:
                        resp = web.StreamResponse(headers={
                            "Content-Type": "text/event-stream",
                            "Cache-Control": "no-cache",
                            "X-Accel-Buffering": "no",
                        })
                        await resp.prepare(request)
                    await resp.write(sse_event(chunk))
            except ConnectionResetError:
                # client went away mid-stream; the finally below closes
                # the ServeStream, which propagates the cancel upstream
                return resp
            except BackPressureError as e:
                if resp is None:
                    return web.json_response(
                        {"error": str(e)}, status=429,
                        headers={"Retry-After":
                                 str(max(1, math.ceil(
                                     getattr(e, "retry_after_s", 1.0))))})
                await resp.write(sse_event({"error": str(e)}, event="error"))
            except RequestTimeoutError as e:
                if resp is None:
                    return web.json_response({"error": str(e)}, status=504)
                await resp.write(sse_event({"error": str(e)}, event="error"))
            except RayServeException as e:
                if resp is None:
                    return web.json_response({"error": str(e)}, status=503)
                await resp.write(sse_event({"error": str(e)}, event="error"))
            except Exception as e:
                if resp is None:
                    return web.json_response({"error": str(e)}, status=500)
                await resp.write(sse_event({"error": str(e)}, event="error"))
            else:
                if resp is None:
                    # empty stream: still a valid SSE exchange
                    resp = web.StreamResponse(headers={
                        "Content-Type": "text/event-stream",
                        "Cache-Control": "no-cache",
                    })
                    await resp.prepare(request)
                await resp.write(SSE_DONE)
            await resp.write_eof()
            return resp
        finally:
            await stream.aclose()

    async def shutdown(self) -> bool:
        if self._runner is not None:
            await self._runner.cleanup()
            self._started = False
        return True


def start_http_proxy(host: str = "127.0.0.1", port: int = 8000) -> tuple[str, int]:
    """Start (or find) the HTTP proxy actor; returns its bound address."""
    import ray_tpu_torch
    from ray_tpu_torch.core.api import remote

    handle = ray_tpu_torch.get_core().get_actor_by_name(PROXY_NAME)
    if handle is None:
        handle = (
            remote(HttpProxy)
            .options(name=PROXY_NAME, get_if_exists=True, num_cpus=0.1)
            .remote(host, port)
        )
    return tuple(ray_tpu_torch.get(handle.ready.remote(), timeout=30))

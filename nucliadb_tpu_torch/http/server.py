"""Tiny asyncio HTTP/1.1 server with a path-template router.

The port's copy of ``nucliadb_tpu/http/server.py``,
kept verbatim: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import logging
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import parse_qs, unquote, urlparse

MAX_BODY = 256 * 1024 * 1024


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        self.status = status
        self.detail = detail
        super().__init__(detail)


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]  # path template params
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes = b""

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body)
        except ValueError as e:
            raise HTTPError(422, f"invalid JSON body: {e}")


class Response:
    """Full-control response: status + body + extra headers. Needed by
    protocol endpoints (TUS resumable uploads) that speak through headers."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 headers: Optional[dict[str, str]] = None,
                 content_type: str = "application/json"):
        self.status = status
        self.body = body
        self.headers = headers or {}
        self.content_type = content_type


class Pace:
    """Yielded by a StreamingResponse iterator to ask the ASYNC writer to
    sleep — a generator calling time.sleep would pin one of the few shared
    executor workers for its whole idle poll (N idle SSE clients would
    starve every other request)."""

    def __init__(self, seconds: float):
        self.seconds = seconds


class StreamingResponse:
    """Chunked-transfer response: `chunks` is a sync iterator of str/bytes
    (or Pace sleep markers), pulled on the executor so slow producers (bus
    polls, model streams) never block the event loop. Used for SSE
    notifications and ndjson /ask (parity: reference reader SSE + ask's
    StreamingResponse)."""

    def __init__(self, chunks, content_type: str = "application/octet-stream",
                 status: int = 200):
        self.chunks = iter(chunks)
        self.content_type = content_type
        self.status = status


Handler = Callable[[Request], Any]

_PARAM_RE = re.compile(r"\{(\w+)\}")


def _compile(pattern: str) -> re.Pattern:
    regex = _PARAM_RE.sub(lambda m: f"(?P<{m.group(1)}>[^/]+)", pattern)
    return re.compile("^" + regex + "$")


_STATUS_TEXT = {
    200: "OK", 201: "Created", 204: "No Content",
    400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 409: "Conflict", 412: "Precondition Failed",
    413: "Payload Too Large", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
}

logger = logging.getLogger("nucliadb_tpu.http")

# distinct from None so a generator yielding None isn't misread as EOF
_STREAM_END = object()


class Router:
    def __init__(self) -> None:
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        self.templates: list[str] = []  # raw pattern per routes[i]

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self.routes.append((method.upper(), _compile(pattern), handler))
        self.templates.append(pattern)

    def get(self, pattern: str):
        return lambda fn: (self.add("GET", pattern, fn), fn)[1]

    def post(self, pattern: str):
        return lambda fn: (self.add("POST", pattern, fn), fn)[1]

    def patch(self, pattern: str):
        return lambda fn: (self.add("PATCH", pattern, fn), fn)[1]

    def delete(self, pattern: str):
        return lambda fn: (self.add("DELETE", pattern, fn), fn)[1]

    def head(self, pattern: str):
        return lambda fn: (self.add("HEAD", pattern, fn), fn)[1]

    def options(self, pattern: str):
        return lambda fn: (self.add("OPTIONS", pattern, fn), fn)[1]

    def put(self, pattern: str):
        return lambda fn: (self.add("PUT", pattern, fn), fn)[1]

    def resolve(self, method: str, path: str) -> Optional[tuple[Handler, dict[str, str]]]:
        for m, regex, handler in self.routes:
            if m != method:
                continue
            match = regex.match(path)
            if match:
                return handler, {k: unquote(v) for k, v in match.groupdict().items()}
        return None


class HTTPServer:
    def __init__(self, router: Router, host: str = "127.0.0.1", port: int = 8080,
                 auth_hook=None, reuse_port: bool = False):
        self.router = router
        self.host = host
        self.port = port
        self.auth_hook = auth_hook  # callable(Request) raising HTTPError
        # SO_REUSEPORT listener sharing: N worker processes bind the same
        # port and the kernel balances connections across them (the
        # multi-worker standalone mode — the reference's uvicorn-replicas
        # deployment story, standalone/run.py:84-147)
        self.reuse_port = reuse_port
        # replica mode: called before local dispatch; returning a Response
        # means the request was proxied (standalone/workers.py)
        self.forward_hook = None
        self._server: Optional[asyncio.AbstractServer] = None
        # synchronous handlers run on this pool; wide enough that
        # concurrent searches actually ARRIVE concurrently — the vector
        # query coalescer (index/vector/batcher.py) then merges them into
        # shared device dispatches, so more workers does not mean more
        # device programs (env: NUCLIADB_TPU_HTTP_WORKERS)
        import os as _os

        self._pool = ThreadPoolExecutor(
            max_workers=int(_os.environ.get("NUCLIADB_TPU_HTTP_WORKERS", 32))
        )

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, reuse_port=self.reuse_port or None
        )
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._pool.shutdown(wait=False)

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except HTTPError as e:
                    # malformed request line / oversized body: answer, then
                    # close (the stream position can no longer be trusted)
                    await self._write_response(
                        writer, e.status,
                        json.dumps({"detail": e.detail}).encode(), False,
                    )
                    break
                except ValueError:
                    await self._write_response(
                        writer, 400,
                        json.dumps({"detail": "malformed request"}).encode(), False,
                    )
                    break
                if request is None:
                    break
                status, payload = await self._dispatch(request)
                keep_alive = request.headers.get("connection", "keep-alive") != "close"
                if isinstance(payload, StreamingResponse):
                    completed = await self._write_streaming(writer, payload, keep_alive)
                    if not keep_alive or not completed:
                        break
                    continue
                is_head = request.method == "HEAD"
                if isinstance(payload, Response):
                    await self._write_response(
                        writer, payload.status, payload.body, keep_alive,
                        content_type=payload.content_type, extra=payload.headers,
                        is_head=is_head,
                    )
                    if not keep_alive:
                        break
                    continue
                await self._write_response(
                    writer, status, payload, keep_alive, is_head=is_head
                )
                if not keep_alive:
                    break
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _read_request(self, reader: asyncio.StreamReader) -> Optional[Request]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _ = line.decode("latin1").strip().split(" ", 2)
        except ValueError:
            raise HTTPError(400, "malformed request line")
        headers: dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0))
        except ValueError:
            raise HTTPError(400, "invalid Content-Length")
        if length > MAX_BODY:
            raise HTTPError(413, "body too large")
        body = await reader.readexactly(length) if length else b""
        parsed = urlparse(target)
        # repeated params (?show=a&show=b) collapse to "a,b" — handlers
        # accept the comma form (FastAPI-style repeated query params parity)
        query = {k: ",".join(v) for k, v in parse_qs(parsed.query).items()}
        return Request(
            method=method.upper(),
            path=parsed.path,
            params={},
            query=query,
            headers=headers,
            body=body,
        )

    async def _dispatch(self, request: Request) -> tuple[int, bytes]:
        if self.auth_hook is not None:
            try:
                self.auth_hook(request)
            except HTTPError as e:
                return e.status, json.dumps({"detail": e.detail}).encode()
        loop = asyncio.get_running_loop()
        if self.forward_hook is not None:
            try:
                fwd = await loop.run_in_executor(self._pool, self.forward_hook, request)
            except HTTPError as e:
                return e.status, json.dumps({"detail": e.detail}).encode()
            if fwd is not None:
                return fwd.status, fwd
        resolved = self.router.resolve(request.method, request.path)
        if resolved is None:
            return 404, json.dumps({"detail": "not found"}).encode()
        handler, params = resolved
        request.params = params
        try:
            result = await loop.run_in_executor(self._pool, handler, request)
            status = 200
            if isinstance(result, tuple):
                status, result = result
            if isinstance(result, (StreamingResponse, Response)):
                return result.status, result
            if result is None:
                return status, b""
            if hasattr(result, "model_dump_json"):
                return status, result.model_dump_json().encode()
            if isinstance(result, (bytes, bytearray)):
                return status, bytes(result)
            return status, json.dumps(result).encode()
        except HTTPError as e:
            return e.status, json.dumps({"detail": e.detail}).encode()
        except KeyError as e:
            return 404, json.dumps({"detail": str(e)}).encode()
        except ValueError as e:
            return 422, json.dumps({"detail": str(e)}).encode()
        except Exception:
            # log server-side; never leak tracebacks/paths to remote callers
            logger.exception(
                "unhandled error serving %s %s", request.method, request.path
            )
            return 500, json.dumps({"detail": "internal error"}).encode()

    async def _write_streaming(
        self, writer: asyncio.StreamWriter, resp: StreamingResponse, keep_alive: bool
    ) -> bool:
        """Returns True iff the stream completed (terminator written)."""
        text = _STATUS_TEXT.get(resp.status, "Unknown")
        head = (
            f"HTTP/1.1 {resp.status} {text}\r\n"
            f"Content-Type: {resp.content_type}\r\n"
            "Transfer-Encoding: chunked\r\n"
            "Cache-Control: no-cache\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        ).encode("latin1")
        writer.write(head)
        await writer.drain()
        loop = asyncio.get_running_loop()
        while True:
            try:
                chunk = await loop.run_in_executor(self._pool, next, resp.chunks, _STREAM_END)
            except Exception:
                # abort WITHOUT the chunked terminator: the client must see
                # truncation, not a cleanly completed response
                logger.exception("streaming response producer failed")
                return False
            if chunk is _STREAM_END:
                break
            if chunk is None:
                continue
            if isinstance(chunk, Pace):
                await asyncio.sleep(chunk.seconds)
                continue
            data = chunk.encode() if isinstance(chunk, str) else bytes(chunk)
            if not data:
                continue
            writer.write(f"{len(data):x}\r\n".encode("latin1") + data + b"\r\n")
            try:
                await writer.drain()
            except ConnectionError:
                return False
        writer.write(b"0\r\n\r\n")
        await writer.drain()
        return True

    async def _write_response(
        self, writer: asyncio.StreamWriter, status: int, payload: bytes, keep_alive: bool,
        content_type: str = "application/json", extra: Optional[dict[str, str]] = None,
        is_head: bool = False,
    ) -> None:
        text = _STATUS_TEXT.get(status, "Unknown")
        lines = [
            f"HTTP/1.1 {status} {text}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(payload)}",
            f"Connection: {'keep-alive' if keep_alive else 'close'}",
        ]
        for name, value in (extra or {}).items():
            lines.append(f"{name}: {value}")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin1")
        # HEAD responses advertise the length but must not carry the body
        writer.write(head if is_head else head + payload)
        await writer.drain()

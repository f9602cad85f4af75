"""Minimal asyncio HTTP server + router.

The port's copy of ``nucliadb_tpu/http/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

The reference serves its REST API with FastAPI/uvicorn; this image has
neither, so the product API runs on a small stdlib HTTP/1.1 server with a
path-template router, JSON bodies, pydantic validation at the handlers, and
a thread pool for the (synchronous) service calls. The API surface itself
mirrors the reference's v1 REST routes (see standalone/app.py).
"""

from .server import (
    HTTPError, HTTPServer, Pace, Request, Response, Router, StreamingResponse,
)

__all__ = [
    "HTTPServer", "Router", "Request", "Response", "HTTPError",
    "StreamingResponse", "Pace",
]

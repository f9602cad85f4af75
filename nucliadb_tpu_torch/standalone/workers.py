"""Multi-worker standalone serving: SO_REUSEPORT read replicas.

The single-process standalone tops out on host-side Python (~8-9 ms of
parse/plan/serialize per /find on this class of host — the GIL serializes
it no matter how many threads serve). The reference's deployment story is
horizontal: N uvicorn replicas behind an ingress (standalone/run.py:84-147
scaled by replicas; component mode splits writer/search apps). This module
is the single-box analogue:

- N worker processes bind the SAME port with ``SO_REUSEPORT``; the kernel
  balances connections across them.
- Worker 0 is the PRIMARY: it owns ingest, background merges/GC and boot
  migrations, exactly like the single-process app.
- The others are READ REPLICAS over the same data dir (sqlite WAL +
  file-storage segments): they serve the read plane locally (find/search/
  ask/suggest/graph/catalog/resource GETs/...) and transparently proxy
  write requests to the primary's private listener. Their background loop
  only syncs the searcher (the reference searcher's timer sync, sync.rs),
  so a replica serves index state at most ``sync_interval`` behind the
  primary — the same eventual consistency a scaled reference deployment
  has between its writer and searcher pods.

On a multi-chip TPU deployment the component mode (cluster/ + substrate/)
is the right scale-out — searcher processes own device arenas and API
processes scatter-gather — since every standalone replica embeds its own
arena copy. Multi-worker standalone targets the host-bound product plane.

Counterpart of ``nucliadb_tpu/standalone/workers.py``: replicas run the
port's entry point. On one card each replica is its own process with its
own CUDA context and its own copy of the arenas in the card's memory.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..http import Request, Response

logger = logging.getLogger(__name__)

# POST endpoints that are pure reads (safe + hot on replicas). Everything
# else non-GET/HEAD/OPTIONS is forwarded to the primary.
_READ_POST_SUFFIXES = (
    "/find", "/search", "/catalog", "/suggest", "/ask", "/graph",
    "/graph/nodes", "/graph/relations", "/graph/paths", "/retrieve",
    "/hydrate", "/augment", "/summarize",
)
_READ_POST_SEGMENTS = ("/predict/",)


def is_read_request(request: Request) -> bool:
    if request.method in ("GET", "HEAD", "OPTIONS"):
        return True
    if request.method != "POST":
        return False
    path = request.path.rstrip("/")
    if any(path.endswith(s) for s in _READ_POST_SUFFIXES):
        return True
    return any(seg in path for seg in _READ_POST_SEGMENTS)


# hop-by-hop / recomputed headers never relayed verbatim
_DROP_REQ_HEADERS = {"host", "connection", "content-length", "transfer-encoding"}
_DROP_RESP_HEADERS = {
    "connection", "content-length", "transfer-encoding", "content-type",
    "cache-control", "keep-alive", "date", "server",
}


def make_forward_hook(primary_url: str):
    """server.forward_hook for a replica: proxy write requests to the
    primary, serve reads locally (return None)."""
    import httpx

    client = httpx.Client(base_url=primary_url, timeout=600.0)

    def forward(request: Request) -> Optional[Response]:
        if is_read_request(request):
            return None
        headers = {
            k: v for k, v in request.headers.items() if k not in _DROP_REQ_HEADERS
        }
        # mark the hop so a misconfigured replica-of-replica fails loud
        # instead of looping
        if headers.get("x-ndbtpu-forwarded"):
            raise RuntimeError("forwarding loop: replica proxied to a replica")
        headers["x-ndbtpu-forwarded"] = "1"
        target = request.path
        if request.query:
            from urllib.parse import urlencode

            target += "?" + urlencode(request.query)
        resp = client.request(
            request.method, target, content=request.body, headers=headers
        )
        extra = {
            k: v for k, v in resp.headers.items()
            if k.lower() not in _DROP_RESP_HEADERS
        }
        return Response(
            status=resp.status_code,
            body=resp.content,
            content_type=resp.headers.get("content-type", "application/json"),
            headers=extra,
        )

    return forward


def spawn_replicas(
    n: int,
    *,
    data_dir: str,
    host: str,
    port: int,
    extra_args: Optional[list[str]] = None,
) -> list:
    """Launch ``n`` replica worker processes against an already-listening
    primary. Returns the Popen handles (caller owns shutdown)."""
    import os
    import subprocess
    import sys

    procs = []
    for i in range(n):
        # --replica-of comes through extra_args ("auto": the replica reads
        # the primary's PRIVATE address from <data-dir>/primary.json — the
        # shared SO_REUSEPORT port must never be the forward target)
        cmd = [
            # the port's entry point, not the JAX package's
            sys.executable, "-m", "nucliadb_tpu_torch.standalone.run",
            "--data-dir", data_dir, "--host", host, "--port", str(port),
        ] + list(extra_args or [])
        procs.append(subprocess.Popen(cmd, env=dict(os.environ)))
    return procs

"""Dynamic topology: node-list watch + re-placement on change.

Parity target: the reference's searcher watches Kubernetes pods and
re-selects/re-syncs shards when the node set changes
(nidx/src/searcher/shard_selector.rs:55-150, sync.rs:84-90). No K8s API
exists in this deployment model, so the equivalent seam is a watched
node-list FILE (or env var) — the operator (or an orchestrator sidecar)
rewrites it and every process converges:

- the shared ``ShardSelector`` updates in place, so searchers gating
  ownership via ``nodes_for_shard`` drop shards they no longer own at
  their next sync and pick up newly-owned ones,
- scatter routers get their backend map rebuilt (removed nodes closed,
  added nodes dialed via ``make_backend``).

File format: JSON — either ``["name", ...]`` or
``[{"name": ..., "address": ...}, ...]`` (addresses feed ``make_backend``).
``NDBTPU_CLUSTER_NODES`` (comma-separated ``name[=address]``) overrides the
file when set, for env-driven deployments.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Optional

from .selector import ShardSelector

ENV_NODES = "NDBTPU_CLUSTER_NODES"


def _parse_nodes(raw) -> list[tuple[str, Optional[str]]]:
    out: list[tuple[str, Optional[str]]] = []
    for entry in raw:
        if isinstance(entry, str):
            out.append((entry, None))
        else:
            out.append((entry["name"], entry.get("address")))
    return out


class TopologyWatcher:
    """Watches a node-list source and applies changes to a shared selector
    (+ optionally a backend map for scatter-gather)."""

    def __init__(
        self,
        path: str | None = None,
        *,
        replication: int = 2,
        make_backend: Optional[Callable[[str, Optional[str]], object]] = None,
        on_change: Optional[Callable[[list[str], list[str]], None]] = None,
    ):
        self.path = path
        self.make_backend = make_backend
        self.on_change = on_change
        self._mtime: float | None = None
        self._stop = threading.Event()
        nodes = self._read()
        self.addresses: dict[str, Optional[str]] = dict(nodes)
        self.selector = ShardSelector([n for n, _ in nodes], replication)
        self.backends: dict[str, object] = {}
        if make_backend is not None:
            for name, addr in nodes:
                self.backends[name] = make_backend(name, addr)

    # ------------------------------------------------------------------

    def _read(self) -> list[tuple[str, Optional[str]]]:
        env = os.environ.get(ENV_NODES)
        if env:
            out = []
            for part in env.split(","):
                part = part.strip()
                if not part:
                    continue
                name, _, addr = part.partition("=")
                out.append((name, addr or None))
            return out
        if self.path and os.path.exists(self.path):
            with open(self.path) as f:
                return _parse_nodes(json.load(f))
        return []

    def refresh(self) -> bool:
        """Re-read the source; apply node additions/removals. Returns True
        if the topology changed."""
        nodes = self._read()
        names = [n for n, _ in nodes]
        old = list(self.selector.nodes)
        membership_changed = self.selector.set_nodes(names)
        # address-only changes (a node restarting elsewhere) must redial
        # even when the member set is identical
        address_changed = dict(nodes) != self.addresses
        if not membership_changed and not address_changed:
            return False
        moved = {
            name
            for name, addr in nodes
            if name in self.addresses and self.addresses.get(name) != addr
        }
        for name in moved & set(self.backends):
            stale = self.backends.pop(name)
            close = getattr(stale, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    pass
        if self.make_backend is not None:
            for gone in set(self.backends) - set(names):
                backend = self.backends.pop(gone)
                close = getattr(backend, "close", None)
                if callable(close):
                    try:
                        close()
                    except Exception:
                        pass
            for name, addr in nodes:
                if name not in self.backends:
                    self.backends[name] = self.make_backend(name, addr)
        # record the applied addresses only AFTER the backends rebuilt: a
        # make_backend failure leaves address_changed true so the next
        # refresh() retries instead of leaving the node backend-less
        self.addresses = dict(nodes)
        if self.on_change is not None:
            self.on_change(old, names)
        return True

    # ------------------------------------------------------------------

    def _poll_once(self) -> bool:
        if os.environ.get(ENV_NODES):
            return self.refresh()
        if not self.path:
            return False
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            mtime = None
        if mtime == self._mtime:
            return False
        # record the mtime only after a SUCCESSFUL refresh — a raising
        # refresh (backend dial failure, on_change error) must stay
        # retryable at the next poll rather than skipping the change until
        # the file is touched again
        changed = self.refresh()
        self._mtime = mtime
        return changed

    def start(self, interval_s: float = 2.0) -> None:
        """Background mtime poll (parity cadence: the reference's pod
        reflector pushes; a small poll interval is the file equivalent)."""

        def loop():
            log = logging.getLogger(__name__)
            while not self._stop.wait(interval_s):
                try:
                    self._poll_once()
                except Exception:
                    log.warning("topology poll failed; will retry",
                                exc_info=True)

        threading.Thread(target=loop, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()

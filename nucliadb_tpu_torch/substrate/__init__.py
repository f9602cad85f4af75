"""Network substrate: the PG + NATS + object-store roles over one gRPC plane.

The reference deploys indexer / scheduler / worker / searcher on separate
hosts against network services — PostgreSQL metadata
(nidx/src/metadata.rs:37-100), a NATS JetStream ingestion bus
(nidx/src/indexer.rs:121-149), and an object store (segment_store.rs).
This build's equivalents (MetadataStore, EmbeddedBus, maindb Driver,
LocalStorage) are sqlite/file-backed, which scales out only over a shared
filesystem. This module makes them network services:

- ``SubstrateServer`` owns the backing files (run it on ONE host — usually
  next to the api/writer component) and serves every public method of the
  four backends over a single reflective gRPC method
  (``/ndbtpu.Substrate/Call``), msgpack-framed like the rest of the plane.
- ``RemoteMetadataStore`` / ``RemoteBus`` / ``RemoteDriver`` /
  ``RemoteStorage`` are drop-in clients with the same method surface, so
  every component boots unchanged against ``--substrate host:port``.

KV transactions: ``RemoteDriver.transaction()`` buffers writes client-side
and applies them in ONE atomic ``kv_apply`` RPC at commit (reads merge the
buffer over remote state, giving read-your-writes). This matches the
documented Driver contract — plain transactions were never cross-process
atomic; cross-process coordination uses ``compare_and_swap``/``delete_if``,
which forward as single RPCs and keep their atomicity on the server.

The standalone/sqlite fast path is untouched: these classes only engage in
component mode when a substrate address is configured.
"""

from __future__ import annotations

import threading
from concurrent import futures
from dataclasses import fields, is_dataclass
from typing import Any, Iterator, Optional

import grpc
import msgpack

from ..bus.stream import BusMessage, EmbeddedBus
from ..maindb.driver import Driver
from ..metadata.store import (
    IndexMeta,
    MergeJob,
    MetadataStore,
    SegmentRow,
    ShardMeta,
)
from ..storage import LocalStorage
from ..types import Seq

_SERVICE = "/ndbtpu.Substrate/"
from ..grpc_plane.limits import MAX_MSG as _MAX_MSG  # segments stream through put/get blobs

_DATACLASSES = {
    c.__name__: c for c in (ShardMeta, IndexMeta, SegmentRow, MergeJob, BusMessage)
}

# Replication classifies methods by effect: anything NOT read-only is
# shipped to an attached warm standby. The inversion is deliberate — a
# newly added mutating method defaults to replicated (over-shipping a read
# would merely be wasted bytes; under-shipping a write silently diverges
# the standby).
_READ_ONLY: dict[str, frozenset] = {
    "meta": frozenset({
        "last_seq", "get_shard", "list_shards", "get_indexes", "get_index",
        "indexes_updated_since", "ready_segments", "count_ready_segments",
        "deletions_for_index",
        "purgeable_segments", "merge_job_segments", "pending_merge_jobs",
        "ack_floor",
    }),
    "bus": frozenset({"scan", "in_progress", "last_seq", "ack_floor", "pending"}),
    "kv": frozenset({"get", "batch_get", "keys", "count"}),
    "blob": frozenset({"get", "exists", "list"}),
}


def _enc(v: Any) -> Any:
    if isinstance(v, Seq):
        return {"__seq__": int(v)}
    if is_dataclass(v) and type(v).__name__ in _DATACLASSES:
        return {
            "__dc__": type(v).__name__,
            "f": {f.name: _enc(getattr(v, f.name)) for f in fields(v)},
        }
    if isinstance(v, tuple):
        return {"__tup__": [_enc(x) for x in v]}
    if isinstance(v, list):
        return [_enc(x) for x in v]
    if isinstance(v, dict):
        return {k: _enc(x) for k, x in v.items()}
    return v


def _dec(v: Any) -> Any:
    if isinstance(v, dict):
        if "__seq__" in v and len(v) == 1:
            return Seq(v["__seq__"])
        if "__tup__" in v and len(v) == 1:
            return tuple(_dec(x) for x in v["__tup__"])
        if "__dc__" in v and len(v) == 2:
            cls = _DATACLASSES[v["__dc__"]]
            return cls(**{k: _dec(x) for k, x in v["f"].items()})
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


class _KvFacade:
    """Server-side KV target: one-shot reads + an atomic write batch."""

    def __init__(self, driver: Driver):
        self._driver = driver

    def get(self, key: str) -> Optional[bytes]:
        with self._driver as txn:
            return txn.get(key)

    def batch_get(self, keys: list[str]) -> list[Optional[bytes]]:
        with self._driver as txn:
            return txn.batch_get(keys)

    def keys(self, prefix: str, count: int = -1) -> list[str]:
        with self._driver as txn:
            return list(txn.keys(prefix, count))

    def count(self, prefix: str) -> int:
        with self._driver as txn:
            return txn.count(prefix)

    def apply(self, ops: list) -> None:
        """One atomic transaction of buffered writes."""
        with self._driver as txn:
            for op in ops:
                kind = op[0]
                if kind == "set":
                    txn.set(op[1], op[2])
                elif kind == "delete":
                    txn.delete(op[1])
                elif kind == "delete_by_prefix":
                    txn.delete_by_prefix(op[1])
                else:
                    raise ValueError(f"bad kv op: {kind}")

    def compare_and_swap(self, key, expected, new) -> bool:
        return self._driver.compare_and_swap(key, expected, new)

    def delete_if(self, key, expected) -> bool:
        return self._driver.delete_if(key, expected)


class SubstrateServer:
    """Serves the metadata / bus / KV / blob backends over gRPC.

    Warm standby (the HA posture the reference gets from PostgreSQL
    replication, nidx/src/metadata.rs:37-100): a second SubstrateServer
    started with ``follower=True`` serves nothing until promoted. The
    primary's ``attach_follower(addr)`` ships a full snapshot (bootstrap),
    then every mutating RPC is shipped to the standby SYNCHRONOUSLY —
    inside the same critical section as its local execution, BEFORE the
    client's call returns — so an acked write is on both hosts by the time
    the caller sees the ack (zero acked-write loss on primary kill). On
    primary failure the operator calls ``promote()`` (locally or via the
    wire) and points clients at the standby's address.

    Degradation: if a ship fails, the standby is DETACHED (logged loudly)
    and the primary keeps serving — availability over replication, the
    equivalent of dropping a dead PG sync standby from
    synchronous_standby_names. A detached standby must re-bootstrap.
    Statement-shipped ops re-execute on the standby; wall-clock-dependent
    state (merge-job lease expiries, bus redelivery deadlines) may differ
    by the replication delay, which affects retry TIMING only, never acked
    data.

    AUTOMATIC failover (r4): the pieces that turn the warm standby into an
    unattended failover pair —

    - ``watch_primary(addr)`` on the standby probes the primary's
      replication plane; after ``misses`` consecutive unreachable probes it
      self-promotes (and logs loudly). Detection is deliberately on the
      REPLICATION plane: a primary that can still ship ops is alive no
      matter what its serving plane says.
    - ``ha_fence=True`` on the primary inverts the degradation rule to
      consistency-first: a failed ship FENCES the primary (every later
      mutation is refused with "primary fenced" until a standby is
      re-attached) instead of detaching the standby. The mutation whose
      ship failed is itself refused — it executed locally but the local
      state is doomed (a fenced primary must re-bootstrap as a follower to
      rejoin), so the surviving pair never saw it and the client's retry
      lands on the new primary. With the fence on, standby auto-promotion
      cannot split-brain: at most one side accepts writes at any time —
      exactly PG's synchronous_commit=remote_apply + fencing posture the
      reference's metadata tier assumes (nidx/src/metadata.rs:37-100).
    - ``Remote*`` clients accept a comma-separated endpoint list and
      rotate on UNAVAILABLE / "standby not promoted" / "primary fenced",
      so components started with ``--substrate primary:p,standby:p``
      retarget themselves through a failover with no operator action.
    """

    def __init__(
        self,
        data_dir: str,
        address: str = "127.0.0.1:0",
        workers: int = 16,
        follower: bool = False,
        ha_fence: bool = False,
    ):
        import os

        self.data_dir = data_dir
        self.follower = follower
        self.ha_fence = ha_fence
        # an ha_fence primary boots FENCED: writes accepted between start()
        # and attach_follower() would be acked-but-unreplicated, the exact
        # loss the fence exists to rule out. attach_follower lifts it.
        self._fenced = ha_fence and not follower
        self._watch_stop: Optional[threading.Event] = None
        self._repl_lock = threading.Lock()  # total order of mutating ops
        self._repl_fn = None  # primary: stub to the attached standby
        self._repl_chan = None
        self._shipped = 0  # primary: entries shipped
        self._applied = 0  # follower: entries applied
        # fast-path bookkeeping: mutations serialize under _repl_lock ONLY
        # while replication is active (standby attached / attaching, or
        # ha_fence). Otherwise they run concurrently across the gRPC
        # workers, tracked by an in-flight counter attach_follower drains
        # before snapshotting (an untracked mutation racing the snapshot
        # could be acked yet miss both the snapshot and the op stream).
        self._mut_cv = threading.Condition()
        self._mut_inflight = 0
        self._repl_pending = False  # attach_follower in progress
        # set when the pair DIVERGED with local state ahead of the acked
        # prefix (standby applied an op this node failed, or vice versa) —
        # this node must re-bootstrap as a follower; attaching a standby
        # FROM it would resurrect un-acked state into the new pair.
        self._dirty = False
        os.makedirs(data_dir, exist_ok=True)
        if follower:
            # backends open at bootstrap_done (the shipped snapshot), or at
            # promote() for a standby promoted without ever syncing
            self.metadata = self.bus = self.driver = self.storage = None
            self._targets: dict[str, Any] = {}
        else:
            self._open_backends()
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=workers),
            options=[
                ("grpc.max_send_message_length", _MAX_MSG),
                ("grpc.max_receive_message_length", _MAX_MSG),
            ],
        )
        handler = grpc.unary_unary_rpc_method_handler(
            self._call,
            request_deserializer=msgpack.unpackb,
            response_serializer=msgpack.packb,
        )
        self.server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(
                "ndbtpu.Substrate", {"Call": handler}
            ),)
        )
        self.port = self.server.add_insecure_port(address)

    def _open_backends(self) -> None:
        import os

        self.metadata = MetadataStore(os.path.join(self.data_dir, "metadata.db"))
        self.bus = EmbeddedBus(os.path.join(self.data_dir, "bus.db"))
        self.driver = Driver(os.path.join(self.data_dir, "maindb.db"))
        self.storage = LocalStorage(os.path.join(self.data_dir, "blobs"))
        self._targets = {
            "meta": self.metadata,
            "bus": self.bus,
            "kv": _KvFacade(self.driver),
            "blob": self.storage,
        }

    def start(self) -> None:
        self.server.start()

    def stop(self, grace: float = 1.0) -> None:
        if self._watch_stop is not None:
            self._watch_stop.set()
        self.server.stop(grace)
        if self._repl_chan is not None:
            self._repl_chan.close()
            self._repl_chan = self._repl_fn = None

    # -- warm standby ----------------------------------------------------

    def attach_follower(self, address: str, timeout: float = 60.0) -> None:
        """Bootstrap a follower SubstrateServer at ``address`` with a full
        snapshot, then ship every subsequent mutating op synchronously.
        Mutations stall for the duration of the snapshot (it runs under the
        replication lock so the bootstrap + op stream is a consistent
        prefix)."""
        import os
        import shutil
        import tempfile

        chan = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_send_message_length", _MAX_MSG),
                ("grpc.max_receive_message_length", _MAX_MSG),
            ],
        )
        fn = chan.unary_unary(
            _SERVICE + "Call",
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )

        def repl(method, *args):
            out = fn({"t": "repl", "m": method, "a": list(args)}, timeout=timeout)
            if "err" in out:
                raise RuntimeError(f"standby {method} failed: {out['err']}")
            return out.get("v")

        if self._dirty:
            raise RuntimeError(
                "this node diverged from its pair (dirty): it must "
                "re-bootstrap as a follower, not seed a new standby"
            )
        # stop new fast-path (unreplicated) mutations and drain in-flight
        # ones: a mutation racing the snapshot could be acked yet miss both
        # the snapshot and the op stream
        with self._mut_cv:
            self._repl_pending = True
            while self._mut_inflight:
                self._mut_cv.wait()
        try:
            with self._repl_lock:
                tmp = tempfile.mkdtemp(prefix="substrate_bootstrap_")
                try:
                    self.snapshot(tmp)
                    repl("bootstrap_begin")
                    for root, _dirs, files in os.walk(tmp):
                        for name in files:
                            full = os.path.join(root, name)
                            rel = os.path.relpath(full, tmp)
                            with open(full, "rb") as f:
                                repl("bootstrap_file", rel, f.read())
                    repl("bootstrap_done", 0)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
                self._shipped = 0
                self._repl_fn, self._repl_chan = fn, chan
                self._fenced = False  # a (re)attached standby lifts the fence
        finally:
            with self._mut_cv:
                self._repl_pending = False

    def watch_primary(
        self,
        primary_address: str,
        interval: float = 0.5,
        misses: int = 4,
    ) -> None:
        """Standby-side failure detection: probe the primary's replication
        plane every ``interval`` seconds; after ``misses`` consecutive
        unreachable probes, self-promote. Promotion is armed only after the
        primary has been seen ALIVE at least once — a standby that boots
        before (or without) its primary must wait, not spuriously promote
        an empty substrate over a healthy pair. Run the primary with
        ``ha_fence=True`` — detection-by-timeout cannot distinguish a dead
        primary from a partitioned one, and only the fence makes the
        partitioned case safe (the cut-off primary refuses writes the
        moment a ship fails, which is before any probe can miss)."""
        if not self.follower:
            raise ValueError("watch_primary is for unpromoted standbys")
        stop = self._watch_stop = threading.Event()
        self.watch_armed = False  # True once the primary was seen alive

        def probe() -> None:
            # a FRESH connection per probe: a long-lived channel that ever
            # saw the primary down sits in gRPC's reconnect backoff (grows
            # toward minutes) and would report a healthy primary as dead
            with grpc.insecure_channel(primary_address) as chan:
                fn = chan.unary_unary(
                    _SERVICE + "Call",
                    request_serializer=msgpack.packb,
                    response_deserializer=msgpack.unpackb,
                )
                fn({"t": "repl", "m": "status", "a": []}, timeout=interval + 0.5)

        def watch():
            import logging

            log = logging.getLogger(__name__)
            missed = 0
            while not stop.wait(interval):
                if not self.follower:  # promoted externally
                    break
                try:
                    probe()
                    missed = 0
                    self.watch_armed = True
                except grpc.RpcError:
                    if not self.watch_armed:
                        continue  # not armed: primary never seen alive yet
                    missed += 1
                    if missed >= misses:
                        log.error(
                            "primary %s unreachable for %d probes — "
                            "AUTO-PROMOTING this standby (applied=%d)",
                            primary_address, missed, self._applied,
                        )
                        self.promote()
                        break

        threading.Thread(target=watch, daemon=True, name="substrate-watch").start()

    def promote(self) -> None:
        """Make this follower the serving primary (the operator points
        clients at this address). Safe on a never-bootstrapped standby: it
        promotes to an empty substrate. Promotion serves UNFENCED even
        under ha_fence — the promotion (by operator or armed watcher) IS
        the decision to run degraded until a new standby attaches."""
        if not self._targets:
            self._open_backends()
        self.follower = False
        self._fenced = False

    def _ship(self, t: str, m: str, request: dict):
        """Ship one op to the standby BEFORE local execution (called under
        _repl_lock). Returns None when the standby applied it cleanly, or
        the op-level error string when the standby consumed the entry but
        the op itself raised there (deterministic failures re-raise
        identically at the local execution that follows). Transport or
        protocol failures (unreachable standby, replication gap) detach the
        standby — or FENCE this primary under ha_fence — and, because the
        op has not executed locally yet, the refused write leaves no trace
        to resurrect through a later attach_follower snapshot."""
        entry = {
            "i": self._shipped + 1, "t": t, "m": m,
            "a": request.get("a", []), "k": request.get("k", {}),
        }
        try:
            out = self._repl_fn(
                {"t": "repl", "m": "apply", "a": [entry]}, timeout=30.0
            )
            if "err" in out:
                raise RuntimeError(out["err"])
            self._shipped += 1
            return out.get("op_err")
        except Exception:
            import logging

            chan, self._repl_fn, self._repl_chan = self._repl_chan, None, None
            if chan is not None:
                chan.close()
            if self.ha_fence:
                self._fenced = True
                logging.getLogger(__name__).error(
                    "standby ship failed after %d entries — FENCING this "
                    "primary (ha_fence): the op is refused, every further "
                    "mutation is refused until a standby re-attaches, and "
                    "this node must re-bootstrap as a follower to rejoin",
                    self._shipped, exc_info=True,
                )
                raise RuntimeError(
                    "primary fenced: standby unreachable — retry against "
                    "the promoted standby"
                )
            logging.getLogger(__name__).error(
                "standby ship failed after %d entries — DETACHING standby "
                "(it must re-bootstrap); acked writes are no longer "
                "replicated", self._shipped, exc_info=True,
            )

    def _repl_call(self, method: str, request: dict):
        """Replication-plane handler (target ``repl``)."""
        import os

        args = request.get("a", [])
        try:
            if method == "apply":
                entry = args[0]
                if not self.follower:
                    raise ValueError("not a follower (already promoted?)")
                if not self._targets:
                    raise ValueError("standby not bootstrapped")
                if entry["i"] != self._applied + 1:
                    raise ValueError(
                        f"replication gap: expected {self._applied + 1}, "
                        f"got {entry['i']} — re-bootstrap required"
                    )
                # ship-first protocol: the primary ships BEFORE executing
                # locally, so an op that deterministically fails (bad args,
                # missing key) arrives here too. The entry is still
                # CONSUMED (the stream stays gap-free) and the failure is
                # reported as op_err — the primary's own execution raises
                # the same error to its client; if it does NOT, the primary
                # declares divergence.
                op_err = None
                try:
                    self._execute(
                        entry["t"], entry["m"], entry["a"], entry["k"]
                    )
                except Exception as e:
                    op_err = f"{type(e).__name__}: {e}"
                self._applied = entry["i"]
                return {"v": None, "op_err": op_err}
            if method == "bootstrap_begin":
                if not self.follower:
                    raise ValueError("not a follower (already promoted?)")
                # a re-bootstrap (after detach) must not leave stale sqlite
                # WAL/SHM files shadowing the shipped snapshot: close the
                # old connections and wipe the backing files
                import shutil

                for backend in (self.metadata, self.bus, self.driver):
                    conn = getattr(backend, "_conn", None)
                    if conn is not None:
                        conn.close()
                self._targets = {}
                self.metadata = self.bus = self.driver = self.storage = None
                for entry in os.listdir(self.data_dir):
                    full = os.path.join(self.data_dir, entry)
                    if os.path.isdir(full):
                        shutil.rmtree(full, ignore_errors=True)
                    else:
                        os.unlink(full)
                self._applied = 0
                return {"v": None}
            if method == "bootstrap_file":
                rel, data = args[0], args[1]
                dst = os.path.normpath(os.path.join(self.data_dir, rel))
                root = os.path.normpath(self.data_dir)
                if dst != root and not dst.startswith(root + os.sep):
                    raise ValueError(f"bootstrap path escapes data dir: {rel}")
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(dst, "wb") as f:
                    f.write(data)
                return {"v": None}
            if method == "bootstrap_done":
                self._open_backends()
                self._applied = int(args[0])
                return {"v": None}
            if method == "promote":  # operator promotion over the wire
                self.promote()
                return {"v": None}
            if method == "status":
                return {"v": {"follower": self.follower, "applied": self._applied,
                              "shipped": self._shipped,
                              # auto-failover is live only once the watcher
                              # has seen the primary alive (armed); before
                              # that, a primary death leaves the standby a
                              # follower awaiting manual promote
                              "watch_armed": getattr(self, "watch_armed", False)}}
            raise ValueError(f"bad repl method {method}")
        except Exception as e:
            return {"err": str(e), "err_type": type(e).__name__}

    def snapshot(self, dest_dir: str) -> dict:
        """Online snapshot of the whole substrate (the single-process
        deployment's backup story; matches the reference's reliance on PG
        backups, nidx/src/metadata.rs). sqlite stores use the backup API
        (consistent while serving); blobs hardlink (same fs) or copy.
        Returns counts for observability."""
        import os
        import shutil

        if not self._targets:
            raise ValueError("standby has no state to snapshot (not bootstrapped)")
        os.makedirs(dest_dir, exist_ok=True)
        self.metadata.backup(os.path.join(dest_dir, "metadata.db"))
        self.bus.backup(os.path.join(dest_dir, "bus.db"))
        self.driver.backup(os.path.join(dest_dir, "maindb.db"))
        blob_dst = os.path.join(dest_dir, "blobs")
        n_blobs = 0
        for key in self.storage.list():
            src = self.storage._path(key)
            dst = os.path.join(blob_dst, key)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                os.link(src, dst)
            except OSError:
                shutil.copy2(src, dst)
            n_blobs += 1
        return {"blobs": n_blobs}

    def _execute(self, target_name: str, method: str, args: list, kwargs: dict):
        """Resolve and run one backend call (shared by the serving plane and
        the standby's replication apply). Raises on bad target/method."""
        target = self._targets.get(target_name)
        if target is None or method.startswith("_"):
            raise ValueError(f"bad target/method {target_name}.{method}")
        fn = getattr(target, method, None)
        if fn is None or not callable(fn):
            raise AttributeError(f"no method {target_name}.{method}")
        out = fn(
            *[_dec(a) for a in args],
            **{k: _dec(v) for k, v in kwargs.items()},
        )
        if isinstance(out, Iterator):
            out = list(out)
        return out

    def _call(self, request, context):
        t = request["t"]
        method = request["m"]
        if t == "repl":
            return self._repl_call(method, request)
        if self.follower:
            # split-brain guard: an unpromoted standby serves nothing
            return {"err": "substrate standby not promoted",
                    "err_type": "ValueError"}
        args = request.get("a", [])
        kwargs = request.get("k", {})
        mutating = method not in _READ_ONLY.get(t, frozenset())
        try:
            if mutating:
                out = self._mutate(t, method, args, kwargs, request)
            else:
                out = self._execute(t, method, args, kwargs)
            return {"v": _enc(out)}
        except Exception as e:  # propagate typed errors to the client
            return {"err": str(e), "err_type": type(e).__name__}

    def _mutate(self, t: str, method: str, args: list, kwargs: dict,
                request: dict):
        """One mutating op. With replication active (standby attached /
        attaching, or ha_fence) the op serializes under _repl_lock and is
        shipped to the standby BEFORE it executes locally — so a failed
        ship refuses the op with the primary's state still exactly the
        acked prefix (an executed-then-refused write would silently
        resurrect through the next attach_follower snapshot). Without
        replication, mutations run concurrently across the gRPC workers
        (tracked so attach_follower can drain them)."""
        with self._mut_cv:
            replicated = (
                self.ha_fence
                or self._repl_fn is not None
                or self._repl_pending
            )
            if not replicated:
                self._mut_inflight += 1
        if not replicated:
            try:
                return self._execute(t, method, args, kwargs)
            finally:
                with self._mut_cv:
                    self._mut_inflight -= 1
                    self._mut_cv.notify_all()
        # replicated path: ship first, under the total-order lock. The
        # fence check lives INSIDE the lock — a mutation racing the
        # fencing op must not execute-and-ack unreplicated.
        with self._repl_lock:
            if self._fenced:
                raise RuntimeError(
                    "primary fenced: no attached standby — retry "
                    "against the promoted standby, or attach one"
                )
            if self._repl_fn is not None:
                op_err = self._ship(t, method, request)
                if op_err is not None:
                    # the standby consumed the entry but the op itself
                    # raised there. Deterministic ops raise identically
                    # here — both sides rejected it, the pair is still
                    # consistent, and the client sees the op's error.
                    out = self._execute(t, method, args, kwargs)
                    # local success + standby failure = DIVERGENCE.
                    self._divergence(t, method)
                    return out
                try:
                    return self._execute(t, method, args, kwargs)
                except Exception:
                    # the standby APPLIED this op but local execution
                    # failed (non-deterministic local error): the reverse
                    # divergence. Availability mode detaches the standby
                    # (it re-bootstraps from this primary, erasing the
                    # extra op); ha_fence fences — the standby, which is
                    # ahead of the acked prefix by an UNACKED op, remains
                    # the authoritative survivor.
                    try:
                        self._divergence(t, method, local_ahead=False)
                    except RuntimeError:
                        pass  # the client must see the ORIGINAL op error
                    raise
            return self._execute(t, method, args, kwargs)

    def _divergence(self, t: str, method: str, *, local_ahead: bool = True) -> None:
        """The pair's states differ after an op applied on exactly one
        side. Availability mode detaches the standby — the primary stays
        the source of truth and the detached standby re-bootstraps FROM
        it. Under ha_fence the surviving STANDBY is authoritative: fence
        and refuse; additionally, when LOCAL state is the side holding the
        extra (refused, un-acked) write (``local_ahead``), mark this node
        dirty — a later attach_follower from it would resurrect that write
        into the new pair. When the STANDBY holds the extra op instead,
        local state still equals the acked prefix and stays clean. Called
        under _repl_lock."""
        import logging

        chan, self._repl_fn, self._repl_chan = self._repl_chan, None, None
        if chan is not None:
            chan.close()
        log = logging.getLogger(__name__)
        side = (
            "op succeeded locally, failed on the standby"
            if local_ahead
            else "op applied on the standby, failed locally"
        )
        if self.ha_fence:
            self._fenced = True
            if local_ahead:
                self._dirty = True
            log.error(
                "replication DIVERGENCE on %s.%s (%s) — FENCING%s",
                t, method, side,
                "; this node is dirty and must re-bootstrap as a follower "
                "to rejoin" if local_ahead else "",
            )
            raise RuntimeError(
                "primary fenced: replication diverged — retry against the "
                "promoted standby"
            )
        log.error(
            "replication DIVERGENCE on %s.%s (%s) — standby DETACHED (it "
            "must re-bootstrap); this primary remains the source of truth",
            t, method, side,
        )


_ERR_TYPES = {
    "KeyError": KeyError,
    "FileNotFoundError": FileNotFoundError,
    "ValueError": ValueError,
    "AttributeError": AttributeError,
}


class _Remote:
    """Base client: forwards method calls as Call RPCs.

    ``address`` may be a comma-separated endpoint list (failover pair:
    ``primary:port,standby:port``). The client talks to ONE endpoint at a
    time and rotates to the next on UNAVAILABLE or on the failover-shaped
    refusals ("standby not promoted", "primary fenced") — so a component
    configured with both addresses follows a promotion with no operator
    action (the retargeting half of the reference's PG-HA posture)."""

    _target = ""

    def __init__(self, address: str, timeout: float = 30.0):
        self._addrs = [a.strip() for a in address.split(",") if a.strip()]
        self._addr_i = 0
        self._addr_lock = threading.Lock()
        self._timeout = timeout
        # rotated-away channels are NOT closed until the client closes:
        # another thread may have an RPC in flight on the old channel, and
        # an eager close() fails it with CANCELLED (which the retry loop
        # rightly does not retry — the call may have been delivered)
        self._old_channels: list = []
        self._open_channel(self._addrs[0])

    def _open_channel(self, address: str) -> None:
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_send_message_length", _MAX_MSG),
                ("grpc.max_receive_message_length", _MAX_MSG),
            ],
        )
        self._fn = self._channel.unary_unary(
            _SERVICE + "Call",
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )

    def _rotate(self, seen_fn) -> None:
        """Advance to the next endpoint — but only if ``seen_fn`` is still
        the current stub: concurrent threads failing on the same channel
        must rotate ONCE, not leapfrog past the healthy endpoint."""
        with self._addr_lock:
            if self._fn is not seen_fn:
                return  # another thread already rotated
            self._old_channels.append(self._channel)
            self._addr_i = (self._addr_i + 1) % len(self._addrs)
            self._open_channel(self._addrs[self._addr_i])

    # UNAVAILABLE = the channel could not deliver the request (server down /
    # restarting); the call was NOT processed, so retrying is safe. The
    # window covers a substrate restart (the reference's components likewise
    # ride out a PG/NATS bounce by reconnecting). DEADLINE/INTERNAL are NOT
    # retried: those calls may have been applied server-side. A refusal
    # from an unpromoted standby or a fenced primary is likewise
    # unprocessed-by-construction, so with >1 endpoint it retries on the
    # next one (the promotion window).
    _RETRIES = 40
    _RETRY_SLEEP = 0.25
    _FAILOVER_MSGS = ("standby not promoted", "primary fenced")

    def _call(self, method: str, *args, **kwargs):
        import time as _time

        request = {
            "t": self._target,
            "m": method,
            "a": [_enc(a) for a in args],
            "k": {k: _enc(v) for k, v in kwargs.items()},
        }
        attempt = 0
        while True:
            with self._addr_lock:  # snapshot the stub: _rotate swaps it
                fn = self._fn
            try:
                out = fn(request, timeout=self._timeout)
            except grpc.RpcError as e:
                if (
                    e.code() is not grpc.StatusCode.UNAVAILABLE
                    or attempt >= self._RETRIES
                ):
                    raise
                attempt += 1
                if len(self._addrs) > 1:
                    self._rotate(fn)
                _time.sleep(self._RETRY_SLEEP)
                continue
            if (
                "err" in out
                and len(self._addrs) > 1
                and attempt < self._RETRIES
                and any(m in out["err"] for m in self._FAILOVER_MSGS)
            ):
                attempt += 1
                self._rotate(fn)
                _time.sleep(self._RETRY_SLEEP)
                continue
            break
        if "err" in out:
            exc = _ERR_TYPES.get(out.get("err_type", ""), RuntimeError)
            raise exc(out["err"])
        return _dec(out.get("v"))

    def close(self) -> None:
        with self._addr_lock:
            old, self._old_channels = self._old_channels, []
        for chan in old:
            chan.close()
        self._channel.close()


def _forward(name):
    def method(self, *args, **kwargs):
        return self._call(name, *args, **kwargs)

    method.__name__ = name
    return method


class RemoteMetadataStore(_Remote):
    _target = "meta"


for _m in (
    "next_seq", "last_seq", "open_index_request", "create_shard", "get_shard",
    "list_shards", "update_shard_config",
    "delete_shard", "create_index", "get_indexes", "get_index", "delete_index",
    "retire_index_segments", "touch_index", "indexes_updated_since",
    "create_segment", "create_segments", "commit_operation", "set_segment_size",
    "ready_segments", "count_ready_segments", "deletions_for_index", "purgeable_segments",
    "drop_segment", "purge_deletions_below", "enqueue_merge",
    "take_merge_job", "heartbeat_merge_job", "merge_job_segments",
    "finish_merge_job", "pending_merge_jobs", "record_index_request",
    "ack_index_request", "ack_floor", "prune_acked_requests",
    "expire_stale_requests",
):
    setattr(RemoteMetadataStore, _m, _forward(_m))


class RemoteBus(_Remote):
    _target = "bus"

    def watch(self, stream, callback) -> None:
        """Push notification via background polling (the embedded bus pushes
        in-process; over the network the watcher polls the scan cursor)."""
        # snapshot the cursor BEFORE returning: messages published after
        # watch() returns are guaranteed delivered (snapshotting inside the
        # thread raced the caller's first publish)
        start_cursor = self.last_seq(stream)
        stop = self._watch_stop = getattr(
            self, "_watch_stop", threading.Event()
        )

        def poll():
            import logging

            log = logging.getLogger(__name__)
            cursor = start_cursor
            while not stop.is_set():
                try:
                    for msg in self.scan(stream, after_seq=cursor, limit=100):
                        # advance only AFTER the callback: a raising
                        # callback leaves the cursor behind so the message
                        # is redelivered next scan (at-least-once, like the
                        # embedded bus's push path)
                        callback(msg)
                        cursor = max(cursor, msg.seq)
                except Exception:
                    if stop.is_set():  # channel closed underneath us
                        break
                    log.warning(
                        "substrate bus watch poll failed (stream=%s)",
                        stream, exc_info=True,
                    )
                stop.wait(0.2)

        threading.Thread(target=poll, daemon=True).start()

    def close(self) -> None:
        stop = getattr(self, "_watch_stop", None)
        if stop is not None:
            stop.set()
        super().close()


for _m in (
    "publish", "publish_many", "scan", "next", "ack", "nak", "in_progress",
    "last_seq", "ack_floor", "pending", "purge_older_than", "purge_acked",
):
    setattr(RemoteBus, _m, _forward(_m))


class RemoteStorage(_Remote):
    _target = "blob"


for _m in ("put", "get", "exists", "delete", "list"):
    setattr(RemoteStorage, _m, _forward(_m))


class RemoteTransaction:
    """Client-side buffered transaction (see module docstring)."""

    def __init__(self, driver: "RemoteDriver"):
        self._driver = driver
        self._ops: list[tuple] = []
        self._sets: dict[str, bytes] = {}
        self._deleted: set[str] = set()
        self._deleted_prefixes: list[str] = []

    # -- reads (buffer overlays remote state) ---------------------------

    def _local_state(self, key: str):
        """(handled, value) against the write buffer."""
        if key in self._sets:
            return True, self._sets[key]
        if key in self._deleted:
            return True, None
        for p in self._deleted_prefixes:
            if key.startswith(p):
                return True, None
        return False, None

    def get(self, key: str) -> Optional[bytes]:
        handled, v = self._local_state(key)
        return v if handled else self._driver._call("get", key)

    def batch_get(self, keys: list[str]) -> list[Optional[bytes]]:
        out: list[Optional[bytes]] = [None] * len(keys)
        remote_idx = []
        for i, k in enumerate(keys):
            handled, v = self._local_state(k)
            if handled:
                out[i] = v
            else:
                remote_idx.append(i)
        if remote_idx:
            vals = self._driver._call("batch_get", [keys[i] for i in remote_idx])
            for i, v in zip(remote_idx, vals):
                out[i] = v
        return out

    def keys(self, prefix: str, count: int = -1) -> Iterator[str]:
        remote = self._driver._call("keys", prefix, -1)
        merged = set(remote)
        for k in self._sets:
            if k.startswith(prefix):
                merged.add(k)
        merged -= self._deleted
        for p in self._deleted_prefixes:
            merged = {k for k in merged if not (k.startswith(p) and k not in self._sets)}
        out = sorted(merged)
        if count >= 0:
            out = out[:count]
        return iter(out)

    def count(self, prefix: str) -> int:
        # with a clean buffer the server's O(1) SQL count answers directly
        # (keys() would download the whole key list just to len() it)
        if not self._sets and not self._deleted and not self._deleted_prefixes:
            return self._driver._call("count", prefix)
        return len(list(self.keys(prefix)))

    # -- writes (buffered) ----------------------------------------------

    def set(self, key: str, value: bytes) -> None:
        self._ops.append(("set", key, value))
        self._sets[key] = value
        self._deleted.discard(key)

    def delete(self, key: str) -> None:
        self._ops.append(("delete", key))
        self._sets.pop(key, None)
        self._deleted.add(key)

    def delete_by_prefix(self, prefix: str) -> None:
        self._ops.append(("delete_by_prefix", prefix))
        self._sets = {k: v for k, v in self._sets.items() if not k.startswith(prefix)}
        self._deleted_prefixes.append(prefix)

    def commit(self) -> None:
        if self._ops:
            self._driver._call("apply", self._ops)
        self._ops = []

    def abort(self) -> None:
        self._ops = []


class RemoteDriver(_Remote):
    _target = "kv"

    def transaction(self) -> RemoteTransaction:
        return RemoteTransaction(self)

    def compare_and_swap(self, key, expected, new) -> bool:
        return self._call("compare_and_swap", key, expected, new)

    def delete_if(self, key, expected) -> bool:
        return self._call("delete_if", key, expected)

    # ``with driver`` from concurrent threads: each thread gets its own
    # buffered transaction (they are independent until the atomic apply
    # RPC), tracked on a thread-local stack — a shared attribute would let
    # one thread's __exit__ commit another thread's half-built buffer.
    @property
    def _txn_stack(self) -> list:
        local = self.__dict__.setdefault("_txn_local", threading.local())
        if not hasattr(local, "stack"):
            local.stack = []
        return local.stack

    def __enter__(self) -> RemoteTransaction:
        txn = self.transaction()
        self._txn_stack.append(txn)
        return txn

    def __exit__(self, exc_type, exc, tb) -> None:
        txn = self._txn_stack.pop()
        if exc_type is None:
            txn.commit()
        else:
            txn.abort()

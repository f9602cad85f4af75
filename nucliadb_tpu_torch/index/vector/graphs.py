"""Captured CUDA graphs of a device index's resident int8 route.

The route (``device._search_int8`` or ``device._search_int8_pallas``) queues
about 69 device operations a call, torch calls and ``ctypes`` launches, and
each of them drops and retakes the interpreter lock. Captured once for a
batch shape and replayed, the route is one ``CUDAGraph.replay()`` a call:
the same kernels in the same order on the same buffers, so the same answers
bit for bit.

- **Where.** Only where the launches dominate: at most ``MAX_ROWS`` padded
  query rows, and candidates that come from a slot table (the caller's
  gate), so a graph's memory stays small. Larger batches run eagerly: their
  launches are a few % of a call, and a graph would keep their
  intermediates (``[B, C, D]`` candidate vectors, a ``[B, N]`` estimate
  matrix) reserved for as long as it lives.
- **A ``Replay``** is one graph with its static inputs: one f32 buffer
  holding the padded queries ``[b_pad, D]`` and after them the floor (one
  upload fills both), and the ``[p_pad]`` bool mask the graph reads: a
  buffer of its own for a filtered key, else the index's base mask. It holds
  every tensor the graph reads, since a graph keeps addresses, not tensors,
  and the outputs its capture left in the graph's private memory pool.
- **``GraphCache``** holds an index's replays by key ``(b_pad, top_k, dedup,
  floor present, filtered)``. The floor's value and the mask's rows are
  inputs, never part of the key. A call checks a replay out and checks it in
  only after its fetch has waited for its stream, so no two threads replay
  one graph at once. A key holds at most ``PER_KEY`` replays, an index at
  most ``KEYS`` keys, and the graphs of a card at most a ``MEMORY_SHARE``-th
  of its memory: past any of them a call runs eagerly.
- **Capture.** A new replay answers its first call eagerly, on the caller's
  stream and from the buffers its graph will read; at its check-in, once
  that run is complete, the capture thread captures it, and the call
  returns once it has. Captures stay inside the calls that need them: a
  stream capturing makes a device-wide synchronize in any thread fail, so
  none may be left running when a call returns. The one capture thread
  captures with ``capture_error_mode="thread_local"``, so other threads
  keep launching meanwhile, and never synchronizes the device or empties
  the allocator. Dropped graphs (an index gone, a key evicted, a call
  failed) wait in a list, which the capture thread empties before its next
  capture: a finalizer may run anywhere, a capture included, and does no
  device work.
- **Streams.** PyTorch keeps a cuBLAS workspace for each (handle, stream)
  pair, and a graph keeps the workspace of the stream it was captured on,
  so two graphs captured on one stream, replayed at once on two threads,
  would share it. Each live graph is therefore captured on a stream no
  other live graph was captured on, by the one capture thread (one handle),
  and a dropped graph's stream is captured on again, except after a failed
  call, whose graph may still run. The streams are made for this (PyTorch's
  pool hands its 32 streams a device out in turn, so a pool stream may be
  another thread's, whose launches a capture would take in); each holds a
  workspace (32 MiB on Hopper), counted against the memory share. Replays
  run on the calling thread's stream: one call that drops the interpreter
  lock, where waits between streams would add more.

``GRAPHS`` counts the route's calls on a card: ``replay`` (served by a
replay) and ``eager`` (served without one: a new replay's first call, a
batch past the gate, a key at its cap or past the memory share, a key whose
capture failed), and ``capture`` counts the graphs captured. The share of
``replay`` is the route's engagement.
"""

from __future__ import annotations

import ctypes
import logging
import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from ...utils import counts
from ...utils.counts import LaunchCounter

GRAPHS = LaunchCounter()

# padded query rows up to which the route replays: the coalescer's
# dispatches (8 to 64 rows) are launch-bound, a batch of 2048 is not
MAX_ROWS = 64
# replays a key may hold: the coalescer's dispatchers of a key and a few
# concurrent solo callers
PER_KEY = 8
# keys an index keeps; a new key drops the least recently used key that has
# no replay checked out
KEYS = 32
# the graphs of a card (their pools and their streams' workspaces) hold at
# most this share of its memory: 2.5 GB of an 80 GB card
MEMORY_SHARE = 32

_log = logging.getLogger(__name__)

# the capture thread's state, by device index; only that thread writes it
_BYTES: dict[int, int] = {}  # device memory the graphs and their streams hold
_STREAMS: "dict[int, list[torch.cuda.ExternalStream]]" = {}  # streams free to capture on
_CONTEXTS: dict[int, ctypes.c_void_p] = {}  # the primary context of each device
_LIMITS: dict[int, int] = {}  # each device's memory share in bytes

_JOBS: "queue.Queue" = queue.Queue()
_START = threading.Lock()
_worker: "threading.Thread | None" = None
_DROPPED: "list[Replay]" = []  # graphs the capture thread releases before its next capture
_DROPPED_LOCK = threading.Lock()


@dataclass(eq=False)
class Replay:
    key: tuple
    inputs: torch.Tensor  # [b_pad * D + 1] f32: the padded queries, then the floor
    mask: torch.Tensor  # [p_pad] bool: a filtered key's own buffer, else the base mask
    run: object = None  # the route on these buffers, kept from the first call for the capture
    graph: object = None
    out: tuple = ()
    adds: list = field(default_factory=list)  # the hand-kernel counts of one replay
    stream: object = None  # the stream the graph was captured on, its own while it lives
    bytes: int = 0  # the device memory its capture took
    failed: bool = False  # a call of it failed: it may still run

    @property
    def queries(self) -> torch.Tensor:
        b_pad = self.key[0]
        return self.inputs[:-1].view(b_pad, -1)

    @property
    def floor(self) -> torch.Tensor:
        return self.inputs[-1:]


def key_of(b_pad: int, top_k: int, dedup: bool, floor: bool, filtered: bool) -> tuple:
    return (b_pad, top_k, dedup, floor, filtered)


def new_replay(key: tuple, dim: int, base_mask: torch.Tensor) -> Replay:
    """An uncaptured replay: its input buffers, made outside any graph's pool,
    and the mask it reads (``base_mask``, or for a filtered key a buffer of
    its shape)."""
    b_pad, filtered = key[0], key[4]
    inputs = torch.empty(b_pad * dim + 1, dtype=torch.float32, device=base_mask.device)
    return Replay(key, inputs, torch.empty_like(base_mask) if filtered else base_mask)


def enqueue(r: "Replay | None", run) -> tuple:
    """Queue the route for one call: ``(outputs, mode)``. A captured ``r``
    replays (``"replay"``). An uncaptured one runs ``run()``, the route on
    ``r``'s buffers, and keeps it for its capture (``"capture"``); with no
    ``r`` the call runs ``run()`` alone (``"eager"``)."""
    if r is not None and r.graph is not None:
        out = replay(r)
        GRAPHS.add("replay")
        return out, "replay"
    out = run()
    GRAPHS.add("eager")
    if r is None:
        return out, "eager"
    r.run = run
    return out, "capture"


def replay(r: Replay) -> tuple:
    """Queue ``r``'s graph on the calling thread's stream; its outputs."""
    r.graph.replay()
    counts.count(r.adds)
    return r.out


def _run(job):
    """Run ``job()`` on the capture thread and wait for it to end; what it
    returns, or raises."""
    global _worker
    with _START:
        if _worker is None:
            _worker = threading.Thread(target=_work, name="graph-capture", daemon=True)
            _worker.start()
    done, box = threading.Event(), {}
    _JOBS.put((job, done, box))
    done.wait()
    if "error" in box:
        raise box["error"]
    return box.get("out")


def _work() -> None:
    while True:
        job, done, box = _JOBS.get()
        try:
            box["out"] = job()
        except BaseException as exc:  # handed to the waiting caller
            box["error"] = exc
        finally:
            del job
            done.set()


def settle() -> None:
    """Release the dropped graphs now (they are released before each
    capture)."""
    _run(_reap)


def full(device: torch.device) -> bool:
    """True when the graphs of ``device`` hold its memory share."""
    if device.type != "cuda":
        return False
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = _LIMITS.get(index)
    if limit is None:
        limit = _LIMITS[index] = torch.cuda.get_device_properties(index).total_memory // MEMORY_SHARE
    return _BYTES.get(index, 0) >= limit


def _capture_job(cache: "GraphCache", r: Replay) -> None:
    """On the capture thread: capture ``r`` and hand it to its key, or drop
    it (past the memory share) or refuse its key (a failed capture)."""
    _reap()
    if full(r.inputs.device):
        cache.checkin(r, ok=False)
        return
    try:
        capture(r)
    except Exception:
        _log.error("capture of the resident int8 route failed for key %s; the key runs eagerly",
                   r.key, exc_info=True)
        cache.refuse(r.key)
        cache.checkin(r, ok=False)
        return
    GRAPHS.add("capture")
    cache.checkin(r)


def capture(r: Replay) -> None:
    """Capture ``r.run`` into ``r`` (on the capture thread): its graph with a
    memory pool of its own, captured on a stream of its own; the graph's
    outputs; the ``LaunchCounter`` adds of one run, which each replay counts;
    and the device memory the capture took (the rise of the memory PyTorch
    reserves, an upper bound when other threads allocate meanwhile). The
    first call's eager run loaded the kernels and set each slot scan's
    shared-memory limit."""
    device = r.inputs.device
    torch.cuda.set_device(device)
    graph = torch.cuda.CUDAGraph()
    stream = _lease(device)
    before = torch.cuda.memory_reserved(device)
    try:
        with torch.cuda.stream(stream), counts.recording() as adds:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = r.run()
            finally:
                graph.capture_end()
    except BaseException:
        _STREAMS[device.index].append(stream)  # no graph of it runs
        raise
    r.graph, r.out, r.adds, r.stream = graph, out, adds, stream
    r.bytes = max(torch.cuda.memory_reserved(device) - before, 0)
    _BYTES[device.index] = _BYTES.get(device.index, 0) + r.bytes


def _lease(device: torch.device) -> "torch.cuda.ExternalStream":
    """A stream no live graph was captured on: a free one, else a new one,
    whose cuBLAS workspace for this thread's handle is made here, outside any
    graph's pool, and counted for good (PyTorch keeps it)."""
    free = _STREAMS.setdefault(device.index, [])
    if free:
        return free.pop()
    before = torch.cuda.memory_reserved(device)
    stream = torch.cuda.ExternalStream(_create_stream(device.index), device=device)
    with torch.cuda.stream(stream):
        torch.cuda.current_blas_handle()
    _BYTES[device.index] = _BYTES.get(device.index, 0) + max(torch.cuda.memory_reserved(device) - before, 0)
    return stream


def _create_stream(index: int) -> int:
    """A new non-blocking CUDA stream on device ``index``, made by
    ``cuStreamCreate`` in ``libcuda`` (PyTorch makes none: its streams come
    from its pool)."""
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    ctx = _CONTEXTS.get(index)
    if ctx is None:
        dev = ctypes.c_int()
        check(cuda.cuDeviceGet(ctypes.byref(dev), index), "cuDeviceGet")
        ctx = ctypes.c_void_p()
        check(cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
        _CONTEXTS[index] = ctx
    check(cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    handle = ctypes.c_void_p()
    check(cuda.cuStreamCreate(ctypes.byref(handle), 1), "cuStreamCreate")  # CU_STREAM_NON_BLOCKING
    return handle.value


def _drop(replays) -> None:
    """Leave the graphs of ``replays`` to the capture thread to release."""
    replays = [r for r in replays if r.graph is not None]
    if replays:
        with _DROPPED_LOCK:
            _DROPPED.extend(replays)


def _reap() -> None:
    """Release the dropped graphs (on the capture thread)."""
    with _DROPPED_LOCK:
        replays = _DROPPED[:]
        _DROPPED.clear()
    _release(replays)


def _release(replays) -> None:
    """Drop each graph and its memory from the card's count; its stream is
    captured on again unless a call of it failed."""
    for r in replays:
        r.run, r.out, r.graph = None, (), None
        if r.stream is not None:
            index = r.inputs.device.index
            _BYTES[index] = _BYTES.get(index, 0) - r.bytes
            if not r.failed:
                _STREAMS[index].append(r.stream)
            r.stream, r.bytes = None, 0


class GraphCache:
    """One index's replays by key (see the module docstring)."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._lock = threading.Lock()
        self._free: "OrderedDict[tuple, list[Replay]]" = OrderedDict()
        self._held: dict[tuple, int] = {}  # replays made for a key: free, out or capturing
        self._eager: set[tuple] = set()  # keys whose capture failed

    def checkout(self, key: tuple, make) -> "Replay | None":
        """A free replay of ``key``; else a new one from ``make()`` while the
        key holds fewer than ``PER_KEY`` and the card's graphs less than their
        share (or some wait to be released); else None."""
        dropped = []
        with self._lock:
            if key in self._eager:
                return None
            free = self._free.get(key)
            if free is None:
                dropped = self._evict()
                free = self._free[key] = []
                self._held[key] = 0
            self._free.move_to_end(key)
            if free:
                return free.pop()
            if self._held[key] >= PER_KEY or (full(self.device) and not _DROPPED):
                return None
            self._held[key] += 1
        _drop(dropped)
        try:
            return make()
        except BaseException:
            self.checkin(None, key)
            raise

    def checkin(self, r: "Replay | None", key: "tuple | None" = None, ok: bool = True) -> None:
        """Return ``r`` after its call: a captured replay for the next call of
        its key; a new one that ran its first call is captured first. A
        replay whose call failed (``ok`` False), or whose key is gone, is
        dropped."""
        key = r.key if r is not None else key
        with self._lock:
            if ok and r is not None and key in self._free:
                if r.graph is not None:
                    self._free[key].append(r)
                    return
                capture_now = r.run is not None and key not in self._eager
            else:
                capture_now = False
            if not capture_now and key in self._held:
                self._held[key] -= 1
        if capture_now:
            _run(lambda: _capture_job(self, r))
        elif r is not None:
            r.failed = r.failed or not ok
            _drop([r])

    def refuse(self, key: tuple) -> None:
        """Run ``key`` eagerly from now on: its capture failed."""
        with self._lock:
            self._eager.add(key)

    def _evict(self) -> list:
        """Drop the least recently used keys with no replay out until there is
        room for one more (under ``_lock``); the dropped replays."""
        dropped = []
        while len(self._free) >= KEYS:
            victim = next(
                (k for k, free in self._free.items() if len(free) == self._held[k]), None
            )
            if victim is None:
                break
            dropped += self._free.pop(victim)
            del self._held[victim]
        return dropped

    def close(self) -> None:
        """Drop every free replay (the index is going away); replays still out
        are dropped at their check-in."""
        with self._lock:
            dropped = [r for free in self._free.values() for r in free]
            self._free.clear()
            self._held.clear()
        _drop(dropped)

    def sizes(self) -> dict:
        """Replays held by key: free, out or capturing."""
        with self._lock:
            return dict(self._held)

"""Where a burst of hybrid requests from threads spends its time.

``chip_smoke.py``'s node and /find phases answer the same 64 hybrid
requests one after another and then from 8 threads; the burst can take
longer. This probe builds the node phase's shard (``--path node``: its
corpus, indexing, merge rounds and sync, from ``chip_smoke``) or the /find
phase's knowledge box (``--path find``: the same corpus written through
the ``Processor``), opens it on both keyword routes and, for each route:

- times the 64 requests one after another and from 8 threads, in turns
  (sequential, burst, burst, sequential), under four settings: first with
  every thread on the default stream and every fetch waiting for the whole
  card (the port before its stream per thread: ``thread_stream`` a no-op
  and ``device_fetch`` behind ``torch.cuda.synchronize()``, on a node
  opened under that setting: faithful on the route timed first, the
  device route, before any thread has a stream of its own); then as
  served;
  with the interpreter's switch interval at 0.5 ms instead of 5 ms
  (``sys.setswitchinterval``: a thread that gave up the GIL for a device
  wait or a hand-off gets it back sooner); and with each request's
  paragraph and vector legs run inline on the request thread instead of
  the paragraph leg on the index pool (for /find, only as served); each
  pass also counts the payload parses of hydration;
- profiles one burst with ``torch.profiler`` (CPU and CUDA activity): the
  device time of its kernels and copies, and the host operators by self
  time;
- samples every thread's Python stack each millisecond during one burst
  and counts the innermost frame of the port or of the thread machinery
  it waits in.

Run from the root of a checkout, on the card:

    python3 -m nucliadb_tpu_torch.tools.burst_profile [--path node|find] [--resources N] [--trace PATH]

It prints the card's name and power limit, then one JSON line per part.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

SETTINGS = ("whole_device_wait", "served", "switch_0.5ms", "inline_legs")
THREADS = 8


def _run(search, reqs, threads: int) -> float:
    """Host ms to answer ``reqs`` one after another (threads=1) or from
    ``threads`` threads, each taking every threads-th request."""
    errors = []

    def worker(ix):
        try:
            for i in ix:
                search(reqs[i])
        except BaseException as exc:  # reported below
            errors.append(exc)

    t = time.perf_counter()
    if threads == 1:
        worker(range(len(reqs)))
    else:
        pool = [threading.Thread(target=worker, args=(range(w, len(reqs), threads),)) for w in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=600)
        if any(th.is_alive() for th in pool):
            raise RuntimeError("a burst thread did not finish")
    if errors:
        raise errors[0]
    return (time.perf_counter() - t) * 1e3


def _setting(name: str):
    """Apply one setting; returns the function that undoes it."""
    from ..index.text_engine import engine
    from ..index.vector import device
    from ..shard.searcher import ShardSearcher

    if name == "whole_device_wait":
        def fetch(*tensors):
            if any(t.is_cuda for t in tensors):
                torch.cuda.synchronize()
            return tuple(t.detach().cpu().numpy() for t in tensors)

        real = [(m, a, getattr(m, a)) for m in (engine, device) for a in ("thread_stream", "device_fetch")]
        for m, a, _ in real:
            setattr(m, a, fetch if a == "device_fetch" else (lambda dev: None))
        return lambda: [setattr(m, a, f) for m, a, f in real]
    if name == "switch_0.5ms":
        old = sys.getswitchinterval()
        sys.setswitchinterval(0.0005)
        return lambda: sys.setswitchinterval(old)
    if name == "inline_legs":
        real = ShardSearcher._legs_host_resident
        ShardSearcher._legs_host_resident = lambda self, request: True
        return lambda: setattr(ShardSearcher, "_legs_host_resident", real)
    return lambda: None


def _sampled(fn, period_s: float = 0.001) -> tuple[float, list]:
    """Runs ``fn()`` while a sampler thread records, every ``period_s``,
    the innermost frame of each other thread that lies in the port, in
    ``threading``/``concurrent`` (a wait) or in ``torch``; returns (ms of
    ``fn``, the 20 most sampled frames with their counts)."""
    counts: collections.Counter = collections.Counter()
    done = threading.Event()
    me = threading.get_ident()

    def sample():
        while not done.is_set():
            for ident, frame in sys._current_frames().items():
                if ident in (me, threading.get_ident()):
                    continue
                f = frame
                while f is not None:
                    path = f.f_code.co_filename
                    if "nucliadb_tpu_torch" in path or "/threading.py" in path or "/concurrent/" in path or "/torch/" in path:
                        counts[f"{os.path.basename(path)}:{f.f_code.co_name}:{f.f_lineno}"] += 1
                        break
                    f = f.f_back
            time.sleep(period_s)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    t = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t) * 1e3
    done.set()
    sampler.join(timeout=10)
    return ms, counts.most_common(20)


def _profile(fn, trace: str | None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    t = time.perf_counter()
    with profile(activities=activities) as prof:
        fn()
    wall = (time.perf_counter() - t) * 1e3
    averages = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in averages)
    host = sorted(averages, key=lambda e: -e.self_cpu_time_total)[:15]
    if trace:
        prof.export_chrome_trace(trace)
    return {
        "profiled_wall_ms": round(wall, 1),
        "device_ms": round(device_us / 1e3, 3),
        "host_ops_by_self_ms": [[e.key, e.count, round(e.self_cpu_time_total / 1e3, 2)] for e in host],
    }


def _node_routes(chip_smoke, args, tmp):
    """The node phase's shard, built; returns (requests, open a route)."""
    from ..index.vector.config import VectorConfig
    from ..services import EmbeddedNode

    cfg = dict(chip_smoke.NODE_FULL, resources=args.resources, paragraphs=args.paragraphs, delta=0,
               hybrid=args.requests, threaded=args.requests, cpu=0)
    corpus = chip_smoke.NodeCorpus(torch, cfg, args.device)
    node = EmbeddedNode(f"{tmp}/node", device=args.device)
    sid = node.create_shard("kb", {"m": VectorConfig(dimension=cfg["dim"])}, shard_id="shard0")
    for r in range(corpus.R):
        node.index(sid, corpus.resource(r))
    _merge_and_sync(node)

    def open_route():
        node_x = EmbeddedNode(f"{tmp}/node", device=args.device)
        return (lambda req: node_x.search(sid, req)), (lambda: node_x.searcher.shard(sid))

    return [chip_smoke.node_hybrid(corpus, i) for i in range(args.requests)], open_route


def _find_routes(chip_smoke, args, tmp):
    """The /find phase's knowledge box, written through the Processor;
    returns (requests, open a route)."""
    from ..common.kb import KnowledgeBoxManager
    from ..ingest import Processor
    from ..maindb import Driver
    from ..models.api import KnowledgeBoxConfig, VectorSetSpec
    from ..search import SearchService
    from ..services import EmbeddedNode

    cfg = dict(chip_smoke.FIND_FULL, resources=args.resources, paragraphs=args.paragraphs, delta=0,
               hybrid=args.requests, threaded=0, cpu=0)
    corpus = chip_smoke.NodeCorpus(torch, cfg, args.device)
    driver = Driver(f"{tmp}/kv.db")

    def stack(node):
        kbs = KnowledgeBoxManager(driver, node)
        processor = Processor(driver, node, kbs)
        return kbs, processor, SearchService(node, kbs, processor)

    node = EmbeddedNode(f"{tmp}/node", device=args.device)
    kbs, processor, _ = stack(node)
    kbid = kbs.create(KnowledgeBoxConfig(slug="find", vectorsets={"m": VectorSetSpec(dimension=cfg["dim"])}))
    (sid,) = kbs.get_shards(kbid).shards
    rows: dict = {}
    for r in range(corpus.R):
        processor.create_resource(kbid, chip_smoke.find_payload(corpus, r, rows), rid=chip_smoke.node_rid(r),
                                  created=1000.0 + r)
    _merge_and_sync(node)

    def open_route():
        node_x = EmbeddedNode(f"{tmp}/node", device=args.device)
        search = stack(node_x)[2]
        return (lambda req: search.find(kbid, req)), (lambda: node_x.searcher.shard(sid))

    return [chip_smoke.find_request(corpus, i) for i in range(args.requests)], open_route


def _merge_and_sync(node) -> None:
    while True:
        stats = node.tick_background()
        if stats["jobs_enqueued"] == 0 and stats["merged"] == 0:
            break
    node.wait_for_sync()


def _payload_parses():
    """Counts ``CreateResourcePayload.model_validate_json`` calls (the
    payload parses of hydration); returns (read the count, undo)."""
    from ..models.api import CreateResourcePayload

    calls, real = [], CreateResourcePayload.model_validate_json

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    CreateResourcePayload.model_validate_json = counted
    return (lambda: len(calls)), (lambda: setattr(CreateResourcePayload, "model_validate_json", real))


def main(argv=None) -> None:
    import chip_smoke  # the node and /find phases' corpora, from the root of the checkout

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=("node", "find"), default="node",
                        help="hybrid shard requests (node) or hybrid /find through SearchService (find)")
    parser.add_argument("--resources", type=int, default=chip_smoke.NODE_FULL["resources"])
    parser.add_argument("--paragraphs", type=int, default=chip_smoke.NODE_FULL["paragraphs"])
    parser.add_argument("--requests", type=int, default=chip_smoke.NODE_FULL["threaded"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--trace", default=None, help="write the profiled burst's chrome trace here")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
    # /find is hydration under the interpreter lock: only the served setting
    settings = SETTINGS if args.path == "node" else ("served",)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        reqs, open_route = (_node_routes if args.path == "node" else _find_routes)(chip_smoke, args, tmp)
        print(json.dumps({"built": {"path": args.path, "seconds": round(time.perf_counter() - t, 1)}}), flush=True)
        parses, undo_parses = _payload_parses()
        try:
            for route in ("device", "default"):
                if route == "device":
                    os.environ["NDBTPU_TEXT_HOST_TIER"] = "0"  # before this route's node opens its searcher
                else:
                    os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)
                search, shard = open_route()
                times = {}
                for setting in settings:
                    undo = _setting(setting)
                    try:
                        if setting == settings[0]:  # the searcher opens, and the pool threads start, under it
                            if shard().vectors["m"].index.codes is None:
                                raise SystemExit("the vector leg is not on the int8 route: use more resources")
                            _run(search, reqs, 1)  # warm
                        runs = []
                        for threads in (1, THREADS, THREADS, 1):
                            before = parses()
                            runs.append((threads, _run(search, reqs, threads), parses() - before))
                    finally:
                        undo()
                    times[setting] = {
                        "sequential_ms": [round(ms, 1) for n, ms, _ in runs if n == 1],
                        "burst_ms": [round(ms, 1) for n, ms, _ in runs if n > 1],
                        "payload_parses": [[n, p] for n, _, p in runs],
                    }
                print(json.dumps({"route": route, "times": times}), flush=True)
                trace = f"{args.trace}.{route}.json" if args.trace else None
                print(json.dumps({"route": route, "profiled_burst": _profile(lambda: _run(search, reqs, THREADS), trace)}),
                      flush=True)
                ms, frames = _sampled(lambda: _run(search, reqs, THREADS))
                print(json.dumps({"route": route, "sampled_burst_ms": round(ms, 1), "frames": frames}), flush=True)
                del search, shard
        finally:
            undo_parses()
            os.environ.pop("NDBTPU_TEXT_HOST_TIER", None)


if __name__ == "__main__":
    main()

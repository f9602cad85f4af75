"""Run one cell of the benchmark once and make its result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name from the cell's entry in ``BENCHMARK.json``:

- the configuration's file (its ``file``), whose ``system`` key names the
  module under ``benchmark/systems/`` that builds and drives it;
- the traffic mix ``benchmark/traffic/<traffic>.json``, read by the one
  generator (``generator.py``);
- each metric's reader ``benchmark/metrics/<metric>.py``, whose
  ``read(run)`` takes the number from the ``Run`` below, or returns None
  where the run holds nothing to read (the metric is then left out).

A run: build the system and the query pool from the seed, start and warm
up the client threads, then open the window for ``--seconds``; in a traced
run the profiler takes a steady stretch of it (``tracing.take``). Once
every request has finished: read the device's memory peak, check that no
JAX module was loaded, free the program's state, and compare the kept
answers with the plain reference (``check.py``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, corpus, tracing
from .generator import Load, Traffic, Window

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "nucliadb_tpu")
STRETCH_S = 2.0  # the profiled stretch of a traced run
STRETCH_AT = 0.25  # its start, as a share of the window
WARM_QUERIES = 4096  # the warm-up's own query stream


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: str
    config: dict
    traffic: Traffic
    setup_s: float
    window: Window
    numbers: dict
    rows: int
    dim: int
    spans: list = field(default_factory=list)
    take: "tracing.Take | None" = None
    device_calls: "tracing.Calls | None" = None  # the take's DeviceVectorIndex.search calls
    coalescer: "tuple[int, int] | None" = None  # dispatches, queries in the window
    collections: list = field(default_factory=list)  # (generation, seconds) of each gc in the window
    host: dict = field(default_factory=dict)  # readings of the host's speed: the probe, a full collection, CPU seconds


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> tuple[dict, dict]:
    """The cell's entry and its configuration's entry; an unknown name fails."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    configs = {c["name"]: c for c in spec["configs"]}
    cell = cells[name]
    if cell["config"] not in configs:
        raise KeyError(f"workload {name!r} names no configuration of BENCHMARK.json: {cell['config']!r}")
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: Path = ROOT) -> dict:
    with open(root / entry["file"]) as f:
        config = json.load(f)
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} holds configuration {config.get('name')!r}, not {entry['name']!r}")
    return config


def load_traffic(name: str, root: Path = ROOT) -> Traffic:
    path = root / "benchmark" / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file for mix {name!r}: {path}")
    with open(path) as f:
        return Traffic.from_dict(json.load(f))


def metrics_for(spec: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def load_reader(name: str, root: Path = ROOT):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the port's own name begins with the last)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def process_start(now: float) -> float:
    """``time.perf_counter()`` at this process's start (Linux), or ``now``
    where the kernel does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - age if 0 <= age < 3600 else now


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of pure-Python work, the best of three:
    a reading of the host's speed that no change to the program moves."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        x = 0
        for i in range(200_000):
            x += i * i % 7
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, *,
             started: float | None = None, root: Path = ROOT, config: dict | None = None,
             traffic: Traffic | None = None) -> tuple[Run, dict]:
    """One run of a cell on ``device``; ``config`` and ``traffic`` replace
    the cell's own (the tests' small sizes). Returns the run and its
    result line's object."""
    import torch

    started = time.perf_counter() if started is None else started
    spec = load_spec(root)
    cell, config_entry = find_cell(spec, cell_name)
    config = load_config(config_entry, root) if config is None else config
    traffic = load_traffic(cell["traffic"], root) if traffic is None else traffic
    device = torch.device(device)
    kind = "per_layer" if trace else "end_to_end"
    readers = [(m, load_reader(m["name"], root)) for m in metrics_for(spec, cell_name, kind)]

    system = importlib.import_module(f"benchmark.systems.{config['system']}").build(config, seed, device)
    pool = corpus.query_pool(seed, system.d, traffic.pool, device)
    warm = corpus.query_pool(seed, system.d, WARM_QUERIES, device, corpus.WARMUP)
    spans = tracing.Spans()
    if trace:
        system.instrument(spans)
        tracing.warm_up()
    load = Load(traffic, system, pool, warm, seed)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    host = {"probe_ms_before": host_probe_ms()}
    t0 = time.perf_counter()
    gc.collect()
    host["full_collection_s"] = time.perf_counter() - t0
    spans.records.clear()
    before = system.coalescer_counts()
    takes: list = []

    def during(start: float) -> None:
        if not trace:
            return
        stretch = min(STRETCH_S, 0.3 * seconds)
        time.sleep(max(0.0, start + STRETCH_AT * seconds - time.perf_counter()))
        takes.append(tracing.take(
            stretch, system.hand_launches, system.hand_kernels,
            slack=traffic.clients, need_device=device.type == "cuda",
        ))

    collections = []  # the interpreter's garbage collections in the window

    def on_gc(phase, info, at=[0.0]):
        if phase == "start":
            at[0] = time.perf_counter()
        else:
            collections.append((info["generation"], time.perf_counter() - at[0]))

    setup_s = time.perf_counter() - started
    cpu = time.process_time()
    gc.callbacks.append(on_gc)
    try:
        window = load.run(seconds, during)
    finally:
        gc.callbacks.remove(on_gc)
    host["process_cpu_s"] = time.process_time() - cpu
    host["probe_ms_after"] = host_probe_ms()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    after = system.coalescer_counts()
    coalesced = (after[0] - before[0], after[1] - before[1])
    span_list = list(spans.records)
    sampled = load.sampled_due()
    system.free()
    del load, system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check.compare(config, seed, traffic.top_k, traffic.filtered, window.answers, sampled, pool, device)
    numbers["failed"] = window.failed
    numbers["repeated_queries"] = window.repeated
    correct, checks = check.judge(numbers, config["limits"])
    run = Run(
        cell=cell_name, config=config, traffic=traffic, setup_s=setup_s, window=window,
        numbers=numbers, rows=int(config["rows"]), dim=int(config["dimension"]),
        spans=span_list, take=takes[0] if takes else None, coalescer=coalesced,
        collections=collections, host=host,
    )
    if run.take is not None:
        run.device_calls = tracing.calls_in(run.take, [s for s in span_list if s.name == "device_index.search"])
    metrics = {}
    for entry, reader in readers:
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    missing = [entry["name"] for entry, _ in readers if entry["name"] not in metrics]
    if missing and device.type == "cuda":
        # on the card every metric the cell lists has something to read
        raise RuntimeError(f"the run read nothing for the cell's metrics {missing}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": window.attempted, "failed": window.failed,
            "metrics": metrics, "device": dev}
    if run.take is not None:
        dev["busy_s"] = tracing.busy_s(run.take)
        dev["window_s"] = run.take.window_s
        gaps = tracing.idle_gaps(run.take, span_list)
        line["breakdown"] = {
            "device_ops": tracing.top_device_ops(run.take),
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
        }
    line["checks"] = checks
    return run, line


def report(run: Run) -> list[str]:
    """What a run's standard error says besides its checks: the window's
    counts, its latency quantiles, its throughput and the client threads'
    CPU time by quarter, the garbage collections in it, the readings of
    the host's speed, and the traced stretch."""
    w, out = run.window, []
    out.append(f"{run.cell}: {w.attempted} queries in {w.seconds:.3f} s, {w.failed} failed, "
               f"{run.numbers['compared']} compared, setup {run.setup_s:.3f} s, {w.repeated} repeated")
    lat = w.query_latencies_ms()
    if lat.size:
        qs = np.percentile(lat, [0, 5, 25, 50, 75, 90, 95, 99, 100])
        out.append(f"{len(w.latencies_s)} requests; latency ms at 0/5/25/50/75/90/95/99/100 %: "
                   + " ".join(f"{x:.3f}" for x in qs))
    if w.latencies_s and w.seconds > 0:
        # queries answered, and the clients' CPU ms a query, in each quarter of the window, by reply time
        ends = np.array(w.ends) - w.start
        per = np.array([n for _, n in w.latencies_s])
        cpu = np.array(w.cpu_s)
        quarter = np.minimum((4 * ends / w.seconds).astype(int), 3)
        answered = [per[quarter == q].sum() for q in range(4)]
        out.append("qps by quarter of the window: " + " ".join(f"{4 * x / w.seconds:.1f}" for x in answered))
        out.append("client CPU ms a query by quarter: " + " ".join(
            f"{1e3 * cpu[quarter == q].sum() / x:.4f}" if x else "-" for q, x in enumerate(answered)))
    full = [s for g, s in run.collections if g == 2]
    out.append(f"{len(run.collections)} garbage collections in the window, {len(full)} of generation 2 "
               f"taking {sum(full):.3f} s (longest {max(full, default=0.0):.3f} s)")
    h = run.host
    out.append("host: " + ", ".join(f"{k} {v:.4f}" for k, v in h.items()))
    out += [f"a request failed: {err}" for err in w.errors]
    if run.take is not None:
        t, calls = run.take, run.device_calls
        out.append(f"take {t.window_s:.3f} s, {len(t.device_ops)} device ops, {t.seen} hand kernels of "
                   f"{t.launched} launched; " + (
                       f"{calls.count:.3f} device index calls in the stretch holding {len(calls.ops)} ops"
                       if calls is not None else "no device index call wholly inside it"))
    return out


def main(argv: list[str]) -> int:
    started = process_start(time.perf_counter())
    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    spec = load_spec()
    cell, _ = find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} cards, {torch.cuda.device_count()} are visible",
              file=sys.stderr)
        return 2
    run, line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started=started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for text in report(run):
        print(f"benchmark: {text}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} {c['bound']} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0

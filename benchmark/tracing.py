"""Benchmark-side spans and the traced stretch of a ``--trace 1`` run.

Spans are recorded by the benchmark's own wrappers around the calls into
each layer (``Spans.wrap``), on the host clock, with the time spent in
directly nested spans. The device side comes from
``torch.profiler``: a steady stretch of the window (``take``) profiled with
CPU and CUDA activity, exported as a Chrome trace and read back here. Every
device operation in the window is the program's, so a layer's device work
is read from the operations that run while its calls are open
(``calls_in``), with no need to know which thread launched each. The
profiler's clock is tied to the host clock by a mark recorded on the
profiling thread.

The profiler-retake logic is ``chip_smoke.py:profiled``'s, frozen here:
kineto keeps only the device events inside a profile's host-clock window,
and a profile of the H100 has come back short of them, so a take that
holds no device event, or fewer hand kernels inside the take than the
program's wrappers counted launches in it (less those that may still be in
flight at its edges), is taken again, at most ``TAKES`` times. As there,
the profile is held open ``MARGIN_S`` before and after the take: on the
H100 a profile's first tenths of a second came back short of device
events.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

TAKES = 3
MARGIN_S = 0.25  # the profile is open this long before and after its take
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# what the host was doing during an idle gap: the first of these spans
# open on any thread at the gap's middle; "harness" when none is
LABELS = ("device_index.search", "searcher.search", "coalescer.search_one", "request")


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    child_ns: int
    rows: int


class Spans:
    """Spans of the calls the benchmark wraps, from every thread."""

    def __init__(self):
        self.records: list[Span] = []
        self._local = threading.local()

    def wrap(self, name: str, fn, rows_of=None):
        """``fn`` recording a span ``name`` per call; ``rows_of(*args)``
        gives the rows the call was handed."""
        local = self._local
        records = self.records

        def wrapped(*args, **kwargs):
            stack = getattr(local, "stack", None)
            if stack is None:
                stack = local.stack = []
            frame = [0]
            stack.append(frame)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter_ns()
                stack.pop()
                if stack:
                    stack[-1][0] += t1 - t0
                rows = rows_of(*args, **kwargs) if rows_of is not None else 0
                records.append(Span(name, t0, t1, frame[0], rows))

        return wrapped


@dataclass
class Take:
    """One profiled stretch, on the profiler's clock (microseconds)."""

    start_us: float
    end_us: float
    offset_ns: float  # profiler clock (ns) minus the host's perf_counter_ns
    device_ops: list = field(default_factory=list)  # (name, ts, dur), by start
    launched: int = 0  # hand-kernel launches the program's wrappers counted
    seen: int = 0  # hand kernels among the device ops

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6


def warm_up() -> None:
    """Start and stop the profiler once, so that a take in the window does
    not pay its first start (seconds on a CPU, where kineto initialises)."""
    take(0.01, lambda: 0, (), slack=0, need_device=False, margin=0.0)


def take(seconds: float, hand_launches, hand_names, slack: int, need_device: bool = True,
         margin: float = MARGIN_S) -> Take:
    """Profile ``seconds`` of the running window, the profile open
    ``margin`` longer on each side; retake a short take (``need_device``:
    on a card; a CPU run's take has no device side)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for _ in range(TAKES):
        with profile(activities=activities) as prof:
            mark_ns = time.perf_counter_ns()
            with record_function("bench.mark"):
                pass
            time.sleep(margin)
            before = hand_launches()
            with record_function("bench.take"):
                time.sleep(seconds)
            launched = hand_launches() - before
            time.sleep(margin)
        result = _read(prof, mark_ns)
        result.launched = launched
        result.seen = sum(
            1 for name, ts, _ in result.device_ops
            if any(h in name for h in hand_names) and result.start_us <= ts <= result.end_us
        )
        if not need_device or (result.device_ops and result.seen >= launched - slack):
            return result
    raise RuntimeError(
        f"torch.profiler came back short in each of {TAKES} takes: the last saw "
        f"{len(result.device_ops)} device operations and {result.seen} hand kernels where "
        f"the program's wrappers launched {launched}"
    )


def _read(prof, mark_ns: int) -> Take:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, mark_ns)


def parse(events: list, mark_ns: int) -> Take:
    """A take from Chrome-trace events (``ph`` "X") and the host time of
    its mark."""
    mark = window = None
    ops = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name")
        if cat == "user_annotation" and name == "bench.mark":
            mark = float(e["ts"])
        elif cat == "user_annotation" and name == "bench.take":
            window = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        elif cat in DEVICE_CATS:
            ops.append((name, float(e["ts"]), float(e["dur"])))
    if mark is None or window is None:
        raise RuntimeError("the profile holds no bench.mark or bench.take annotation")
    return Take(window[0], window[1], mark * 1e3 - mark_ns, sorted(ops, key=lambda o: o[1]))


def busy_intervals(take: Take) -> list[tuple[float, float]]:
    """The union of the device operations' intervals inside the take."""
    out: list[list[float]] = []
    for _, ts, dur in take.device_ops:
        lo, hi = max(ts, take.start_us), min(ts + dur, take.end_us)
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def busy_s(take: Take) -> float:
    return sum(hi - lo for lo, hi in busy_intervals(take)) / 1e6


def _on_clock(take: Take, span: Span) -> tuple[float, float]:
    return (span.start_ns + take.offset_ns) / 1e3, (span.end_ns + take.offset_ns) / 1e3


@dataclass
class Calls:
    """The device work of a layer's calls in a traced stretch: the stretch
    runs from the first start to the last end of the calls that lie wholly
    inside the take; ``ops`` are the device operations that start in it
    while some call is open, ``shares`` each overlapping call's rows and
    the share of its length inside the stretch. Every device operation of
    the window is the program's, and a call that waits for its results
    has its operations inside it, so for calls made one at a time this is
    exact, and for calls that overlap (several client threads) the shares
    stand for the operations of calls cut by the stretch's ends."""

    ops: list  # (name, dur_us)
    shares: list  # (share, rows)

    @property
    def count(self) -> float:
        return sum(share for share, _ in self.shares)


def calls_in(take: Take, spans: list[Span]) -> "Calls | None":
    """The device work of ``spans`` (one layer's calls) in the take, or None
    where no call lies wholly inside it."""
    timed = sorted((_on_clock(take, s), s.rows) for s in spans)
    inside = [iv for iv, _ in timed if iv[0] >= take.start_us and iv[1] <= take.end_us]
    if not inside:
        return None
    lo, hi = inside[0][0], max(end for _, end in inside)
    shares, open_ = [], []  # open_: the union of the calls' intervals in the stretch
    for (a, b), rows in timed:
        part = min(b, hi) - max(a, lo)
        if part <= 0 or b <= a:
            continue
        shares.append((part / (b - a), rows))
        a, b = max(a, lo), min(b, hi)
        if open_ and a <= open_[-1][1]:
            open_[-1][1] = max(open_[-1][1], b)
        else:
            open_.append([a, b])
    starts = [a for a, _ in open_]
    ops = []
    for name, ts, dur in take.device_ops:
        j = bisect.bisect_right(starts, ts) - 1
        if j >= 0 and ts <= open_[j][1]:
            ops.append((name, dur))
    return Calls(ops, shares)


def idle_gaps(take: Take, spans: list[Span]) -> dict[str, float]:
    """Seconds of the take in which the device ran nothing, summed by what
    the host was doing (``LABELS``) at each gap's middle."""
    gaps, at = [], take.start_us
    for lo, hi in busy_intervals(take):
        if lo > at:
            gaps.append((at, lo))
        at = hi
    if take.end_us > at:
        gaps.append((at, take.end_us))
    # a sweep over the gaps' middles, in order, with the spans open there
    timed = sorted(
        (lo, hi, s.name)
        for s in spans
        for lo, hi in [_on_clock(take, s)]
        if hi >= take.start_us and lo <= take.end_us
    )
    out: dict[str, float] = defaultdict(float)
    active: list[tuple[float, str]] = []
    j = 0
    for lo, hi in gaps:
        mid = (lo + hi) / 2
        while j < len(timed) and timed[j][0] <= mid:
            active.append((timed[j][1], timed[j][2]))
            j += 1
        active = [(end, name) for end, name in active if end >= mid]
        names = {name for _, name in active}
        label = next((n for n in LABELS if n in names), "harness")
        out[label] += (hi - lo) / 1e6
    return dict(out)


def top_device_ops(take: Take, n: int = 10) -> list[list]:
    """The device operations that took most time in the take, by name."""
    total: dict[str, float] = defaultdict(float)
    for name, _, dur in take.device_ops:
        total[name] += dur / 1e6
    return [[name[:200], s] for name, s in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

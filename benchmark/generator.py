"""The one traffic generator: it reads a traffic file's parameters and
drives a system's entry with queries from the pool.

A traffic file (``benchmark/traffic/<mix>.json``) holds:

- ``entry``: the system's entry that each request goes through;
- ``clients``: client threads, each in a closed loop (it sends its next
  request when the last is answered); ``batch``: queries a request;
- ``top_k``; ``filtered``: whether each query carries the configuration's
  label filter;
- ``pool``: distinct queries made in set-up, which the window takes in
  order; a query taken past the pool's end is a repeat, counted by the
  window (``Window.repeated``) and held to 0 by the check, so that no
  cache of results can stand in for a search; ``sample_every``: one
  query in so many, drawn from the seed, has its answer kept for the
  check;
- ``warmup``: ``batches``, the batch sizes each client thread sends once
  straight to the searcher in set-up, and ``requests``, the requests each
  sends through the entry, from a query stream of their own.

Every client thread is started, and warms up, in set-up; the window opens
when all are ready.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import corpus

KEYS = {"entry", "clients", "batch", "top_k", "filtered", "pool", "sample_every", "warmup"}


@dataclass
class Traffic:
    entry: str
    clients: int
    batch: int
    top_k: int
    filtered: bool
    pool: int
    sample_every: int
    warmup: dict

    @staticmethod
    def from_dict(d: dict) -> "Traffic":
        unknown = set(d) - KEYS
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}")
        t = Traffic(**d)
        if t.clients < 1 or t.batch < 1 or t.pool < t.batch or t.sample_every < 1:
            raise ValueError(f"traffic sizes out of range: {d}")
        return t


def sample_indices(seed: int, pool: int, every: int) -> np.ndarray:
    """The sorted pool indices whose answers are kept for the check."""
    rng = np.random.default_rng(corpus.sub_seed(seed, "sample"))
    return np.sort(rng.choice(pool, size=max(1, pool // every), replace=False))


@dataclass
class Window:
    """What a window did: per request its latency, query count and the
    client thread's CPU time, the answers kept, the queries taken,
    repeated and failed, and its length."""

    latencies_s: list = field(default_factory=list)  # (seconds, queries)
    cpu_s: list = field(default_factory=list)  # the client thread's CPU seconds in each answered request
    ends: list = field(default_factory=list)  # each answered request's reply time
    answers: dict = field(default_factory=dict)  # pool index -> (keys, scores)
    attempted: int = 0
    failed: int = 0
    errors: list = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0
    taken: int = 0  # queries taken from the pool, in order
    repeated: int = 0  # queries taken past the end of the pool

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def query_latencies_ms(self) -> np.ndarray:
        if not self.latencies_s:
            return np.zeros(0)
        lat = np.array([s for s, _ in self.latencies_s]) * 1e3
        return np.repeat(lat, [n for _, n in self.latencies_s])


class Load:
    """The client threads of one run: started and warmed up in set-up,
    released into the window by ``run``."""

    def __init__(self, traffic: Traffic, system, pool: np.ndarray, warm: np.ndarray, seed: int):
        self.t = traffic
        self.system = system
        self.pool = pool
        self.warm = warm
        self.sample = sample_indices(seed, traffic.pool, traffic.sample_every)
        self.window = Window()
        self._lock = threading.Lock()
        self._next = 0
        self._ready = threading.Semaphore(0)
        self._go = threading.Event()
        self._deadline = 0.0
        self._warm_error: list = []
        self.threads = [
            threading.Thread(target=self._client, args=(c,), name=f"client-{c}", daemon=True)
            for c in range(traffic.clients)
        ]
        for th in self.threads:
            th.start()
        for _ in self.threads:
            self._ready.acquire()
        if self._warm_error:
            self._go.set()
            raise RuntimeError("warm-up failed") from self._warm_error[0]

    # -- set-up ----------------------------------------------------------

    def _warm_up(self, c: int) -> None:
        t, w = self.t, self.warm
        at = (c * 7919) % w.shape[0]

        def take(n):
            nonlocal at
            idx = (at + np.arange(n)) % w.shape[0]
            at = (at + n) % w.shape[0]
            return w[idx]

        for b in self.t.warmup.get("batches", []):
            self.system.search_batch(take(b), t.top_k, t.filtered)
        for _ in range(self.t.warmup.get("requests", 0)):
            self.system.entries[t.entry](take(t.batch), t.top_k, t.filtered)

    # -- the window ------------------------------------------------------

    def _take(self) -> "np.ndarray | None":
        """The next request's pool indices, or None when the window has
        closed."""
        with self._lock:
            if time.perf_counter() >= self._deadline:
                return None
            lo = self._next
            self._next += self.t.batch
        return np.arange(lo, lo + self.t.batch)

    def _client(self, c: int) -> None:
        try:
            self._warm_up(c)
        except BaseException as exc:  # reported by the constructor
            self._warm_error.append(exc)
        self._ready.release()
        self._go.wait()
        if self._warm_error:
            return
        t, win, entry = self.t, self.window, self.system.entries[self.t.entry]
        while True:
            idx = self._take()
            if idx is None:
                return
            cpu = time.thread_time()
            sent = time.perf_counter()
            lo = int(idx[0])
            repeats = lo + t.batch > t.pool
            # a slice is a view; a request past the pool's end repeats
            # queries (the run then fails its check) and keeps no answer
            q = self.pool[idx % t.pool] if repeats else self.pool[lo : lo + t.batch]
            try:
                answers = entry(q, t.top_k, t.filtered)
            except Exception as exc:  # a failed request counts against the run
                done = time.perf_counter()
                with self._lock:
                    win.failed += t.batch
                    win.attempted += t.batch
                    if len(win.errors) < 3:
                        win.errors.append(repr(exc))
                    win.end = max(win.end, done)
                continue
            done = time.perf_counter()
            cpu = time.thread_time() - cpu
            kept = {} if repeats else {
                int(i): self.system.answer(answers[int(i) - lo])
                for i in self.sample[
                    np.searchsorted(self.sample, lo) : np.searchsorted(self.sample, lo + t.batch)
                ]
            }
            with self._lock:
                win.latencies_s.append((done - sent, t.batch))
                win.cpu_s.append(cpu)
                win.ends.append(done)
                win.attempted += t.batch
                win.answers.update(kept)
                win.end = max(win.end, done)

    def run(self, seconds: float, during=None) -> Window:
        """Open the window for ``seconds``; ``during(window_start)`` runs on
        this thread meanwhile. Returns once every request has finished."""
        win = self.window
        win.start = win.end = time.perf_counter()
        self._deadline = win.start + seconds
        self._go.set()
        try:
            if during is not None:
                during(win.start)
        finally:
            for th in self.threads:
                th.join()
        win.taken = self._next
        win.repeated = max(0, self._next - self.t.pool)
        return win

    def sampled_due(self) -> np.ndarray:
        """The sampled pool indices that the window sent, once it has
        closed (every query taken is sent)."""
        return self.sample[self.sample < min(self.window.taken, self.t.pool)]

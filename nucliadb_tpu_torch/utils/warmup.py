"""Boot-time warm-up: the port's own counterpart of ``nucliadb_tpu/utils/warmup.py``.

The JAX package compiles its exact-scan and BM25 XLA programs at the
smallest bucket so the first query does not pay the compiles. The port has
no compile cache; what a first request would pay is the ``nvcc`` build of
the hand kernels and the first launch of each program. So the warm-up
builds and loads every source under ``csrc/`` (on a CUDA device), runs the
top-2 int8 slot scan once at its smallest eligible shape and runs the BM25
group program (``csrc/bm25_program.cu``) once on a one-group, all-padding
input, on the caller's device. On the CPU the same calls run the plain
versions and nothing is built. Nothing is caught: a kernel that fails to
build raises.

A device is warmed once a process: a later call on a device already done
returns at once, as the JAX package's second call finds its jit cache.
"""

from __future__ import annotations

import logging
import threading
import time

import torch

logger = logging.getLogger(__name__)

_done: set = set()  # the devices warmed in this process
_lock = threading.Lock()


def warmup_kernels(device: "str | torch.device" = "cuda") -> float:
    """Build the kernels and run the hot programs once on ``device`` (once
    a process: a device already warmed returns at once). Returns the
    seconds taken."""
    from ..utils.platform import resolve_device

    t0 = time.monotonic()
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        if dev in _done:
            return time.monotonic() - t0
        _warm(dev)
        _done.add(dev)
    dt = time.monotonic() - t0
    logger.info("kernel warmup done in %.1fs", dt)
    return dt


def _warm(dev: torch.device) -> None:
    from ..index.text_engine.engine import DENSE_QUERY_CAP, TIER_QUERY_CAP, TIER_WIDTHS
    from ..ops import bm25, slot_scan
    from ..utils import kernels
    from ..utils.buckets import bucket
    from ..utils.platform import device_fetch, thread_stream

    if dev.type == "cuda":
        for name in sorted(p.stem for p in kernels.CSRC.glob("*.cu")):
            kernels.load(name)
    thread_stream(dev)

    # the top-2 slot scan at the smallest shape its gate takes (the
    # vector leg of every exact-threshold-sized arena)
    n = 2 * slot_scan.RESIDENT_BLOCK_N
    q = torch.zeros((1, 128), dtype=torch.int8, device=dev)
    codes = torch.zeros((n, 128), dtype=torch.int8, device=dev)
    scale = torch.ones((n,), dtype=torch.float32, device=dev)
    mask = torch.zeros((n,), dtype=torch.bool, device=dev)
    scan = slot_scan.int8_scan_slots_resident2(q, codes, scale, mask)

    # the BM25 group program: one group, tier 0 at its minimum row bucket,
    # the higher tiers one empty row, every query slot padding (-1)
    n_pad = bucket(1)
    tier_rows = [max(1, 4096 // TIER_WIDTHS[0])] + [1] * (len(TIER_WIDTHS) - 1)
    tiers = tuple(
        (
            torch.full((r, w), -1, dtype=torch.int32, device=dev),
            torch.zeros((r, w), dtype=torch.float32, device=dev),
            torch.ones((r, w), dtype=torch.float32, device=dev),
        )
        for w, r in zip(TIER_WIDTHS, tier_rows)
    )
    dense = torch.zeros((1, n_pad), dtype=torch.uint8, device=dev)
    dlen = torch.ones((n_pad,), dtype=torch.float32, device=dev)
    caps = tuple(TIER_QUERY_CAP) + (DENSE_QUERY_CAP,)
    rows = torch.full((sum(caps),), -1, dtype=torch.int32, device=dev)
    idfs = torch.zeros((sum(caps),), dtype=torch.float32, device=dev)
    params = torch.tensor([1.0, 1.0, -3.0e38], dtype=torch.float32, device=dev)
    out = bm25.bm25_groups(
        ((tiers, dense, dlen),), (0,), torch.zeros((n_pad,), dtype=torch.bool, device=dev),
        rows, idfs, params, 10, caps, (len(TIER_WIDTHS),), True,
    )
    device_fetch(*scan, *out)

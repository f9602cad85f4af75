"""BM25 group program: the device half of the keyword leg, in PyTorch and CUDA.

Counterparts of the XLA programs of ``nucliadb_tpu/index/text_engine/engine.py``:
``_tier_contrib`` (:1616), ``_bm25_groups_core`` (:1756), ``_bm25_groups``
(:1855), ``_bm25_groups_batch`` (:1866) and ``_splice_1d`` (:118). They are
jitted XLA code in the JAX package, not Pallas kernels. Here tensors on a
CUDA device go through one hand-written kernel, ``csrc/bm25_program.cu``,
which keeps a tile of each query's row in shared memory and cuts it to
its k best, and the same file's merge kernel, which merges a row's tile
cuts; tensors on the CPU go through the plain version below, torch ops
that the kernels are held against.

The program is written batched: query ``b`` owns row ``b`` of a
``[B, L + 1]`` score buffer, and a single query is a batch of one. Per
query, as in the reference:

1. ``gather_weights``: each posting tier of each group gathers the
   ``[cap, W]`` rows the query scheduled (docs, tfs and per-posting doc
   lengths), weighs them ``idf * tf (K1 + 1) / (tf + K1 (1 - B + B dl /
   avgdl))`` and biases the group-local doc ids by the group's offset;
2. ``scatter_postings``: the weights are added into the score row, and
   (``with_counts``) one hit per lane into a count row;
3. ``add_dense_columns``: the dense uint8 tf columns of stopword-grade
   terms add elementwise into each group's window ``[off, off + n_pad_g)``;
4. ``epilogue`` and ``topk_cut``: ``matched = (counts >= required |
   score > 0) & mask``, the masked top-k with the query's ``min_score``,
   and ``[k ids | k counts]``.

Two things differ from the reference in how, not in what:

- **Out-of-range ids.** The reference sends padding (-1) and empty slots
  to ``L`` and drops them with ``mode="drop"``. Torch's ``index_add_``
  raises on such an id on the CPU and faults on the card, so here they go
  to column ``L``, a sink that is sliced off. The kernel skips them.
- **Determinism.** One scatter-add of every lane would run as atomics in
  no fixed order on the card, and a request could come back with other
  last bits from one call to the next (``SearchAfter`` compares scores
  across requests). Here the scatter runs one slot at a time: a slot is
  one term's posting row within one group, for each query, so its doc ids
  are distinct and no two lanes meet at an address but the sink. Slots add
  in the reference's concatenation order (group, tier, slot), which is
  also the order XLA's sequential scatter sums them in on the CPU. The
  kernel keeps that order (a block owns a tile of a score row and adds
  the slots that hit it one after another) and equals the plain version
  on the card bit for bit.

The kernel's host half is the program table (``Layout``, built by
``group_layout`` and ``arena_layout`` once per refresh): one record a
posting tier or dense block, in the order the plain version adds them,
with the tensors it reads, where its doc ids land in the score row and,
for a wide tier, a lane directory of its ascending rows; a launch adds
each record's slot columns from its ``caps``. The kernel cuts each tile to
its k best (``lax.top_k``'s order) with each entry's count, and the merge
kernel cuts a row from its tiles' cuts (``merge_tile_cuts`` is its plain
version). ``LAUNCHES`` counts the kernels' launches (``"program"``,
``"merge"``); ``DISPATCHES`` counts programs on either device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils import kernels
from ..utils.counts import LaunchCounter
from ..utils.platform import stream_wait
from .topk import NEG_INF, masked_topk

K1 = 1.2
B = 0.75

# device-program dispatches by entry point ("single", "batch", and the
# engine's "arena", "arena_batch"), on either device: shows which route
# served a request (the host WAND tier dispatches nothing)
DISPATCHES = LaunchCounter()
# launches of csrc/bm25_program.cu's kernels ("program", "merge"); chip_smoke.py reads them
LAUNCHES = LaunchCounter()


def splice_1d(arr: torch.Tensor, delta: torch.Tensor, start: int) -> torch.Tensor:
    """A copy of ``arr`` with ``delta`` written from ``start`` (the
    reference's ``dynamic_update_slice``: the previous engine keeps
    ``arr``)."""
    out = arr.clone()
    out[start : start + delta.shape[0]] = delta
    return out


def tier_contrib(docs_m, tfs_m, dls_m, rows, idfs, avgdl):
    """One tier's postings for a batch of queries.

    ``rows`` [Q, c] (-1: empty slot) and ``idfs`` [Q, c] select and weigh
    rows of the tier's ``[T, W]`` docs/tfs/dls matrices; ``avgdl`` is [Q].
    Returns (local doc ids [Q, c, W], weights [Q, c, W], valid [Q, c, W]);
    invalid lanes (padding or an empty slot) weigh 0."""
    safe_rows = rows.clamp_min(0).long()
    d = docs_m[safe_rows]
    tf = tfs_m[safe_rows]
    dl = dls_m[safe_rows]
    norm = tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * dl / avgdl[:, None, None]))
    valid = (d >= 0) & (rows >= 0)[:, :, None]
    w = torch.where(valid, idfs[:, :, None] * norm, 0.0)
    return d, w, valid


def _slot_starts(caps) -> list[int]:
    starts = [0]
    for c in caps:
        starts.append(starts[-1] + c)
    return starts


def gather_weights(groups, offsets, rows, idfs, avgdl, caps, tier_counts, L):
    """Every scheduled tier slot's lanes, in (group, tier) order: a list of
    (score-space ids [Q, c, W] int64 with invalid lanes at the sink ``L``,
    weights [Q, c, W], valid [Q, c, W])."""
    starts = _slot_starts(caps)
    parts = []
    ti = 0
    for gi, (tiers, _dense, _dl) in enumerate(groups):
        for docs_m, tfs_m, dls_m in tiers:
            lo, hi = starts[ti], starts[ti + 1]
            ti += 1
            if hi == lo:
                continue
            d, w, valid = tier_contrib(docs_m, tfs_m, dls_m, rows[:, lo:hi], idfs[:, lo:hi], avgdl)
            ids = torch.where(valid, d.long() + offsets[gi], L)
            parts.append((ids, w, valid))
    return parts


def scatter_postings(parts, n_queries: int, L: int, with_counts: bool, device):
    """Scores (and hit counts) [Q, L + 1] from the gathered lanes; column
    ``L`` is the sink. One ``index_add_`` per slot, in order (see the
    module docstring: distinct ids within a slot make it deterministic)."""
    scores = torch.zeros((n_queries, L + 1), dtype=torch.float32, device=device)
    counts = torch.zeros_like(scores) if with_counts else None
    base = torch.arange(n_queries, device=device)[:, None] * (L + 1)
    for ids, w, valid in parts:
        for j in range(ids.shape[1]):
            idx = (ids[:, j] + base).reshape(-1)
            scores.view(-1).index_add_(0, idx, w[:, j].reshape(-1))
            if with_counts:
                counts.view(-1).index_add_(0, idx, valid[:, j].reshape(-1).float())
    return scores, counts


def add_dense_columns(scores, counts, groups, offsets, rows, idfs, avgdl, caps, tier_counts):
    """Adds each group's dense (stopword-grade) slots into its window of
    ``scores`` [Q, L] (and of ``counts``), in place. Columns past the
    group's live docs carry tf 0, so a window overlapping the next group's
    docs adds nothing there."""
    n_t = sum(tier_counts)
    starts = _slot_starts(caps)
    n_q = scores.shape[0]
    for gi, (_tiers, dense, dl_g) in enumerate(groups):
        lo, hi = starts[n_t + gi], starts[n_t + gi + 1]
        if dense is None or hi == lo:
            continue
        np_g = dense.shape[1]
        off = offsets[gi]
        if off + np_g > scores.shape[1]:
            raise ValueError(f"dense window [{off}, {off + np_g}) runs past the score space {scores.shape[1]}")
        x = K1 * (1.0 - B + B * dl_g / avgdl[:, None])
        gscore = torch.zeros((n_q, np_g), dtype=torch.float32, device=scores.device)
        gcount = torch.zeros_like(gscore) if counts is not None else None
        for j in range(lo, hi):
            row = rows[:, j]
            tf = dense[row.clamp_min(0).long()].float()
            norm = tf * (K1 + 1.0) / (tf + x)
            active = (row >= 0)[:, None] & (tf > 0)
            gscore += torch.where(active, idfs[:, j, None] * norm, 0.0)
            if gcount is not None:
                gcount += active.float()
        scores[:, off : off + np_g] += gscore
        if counts is not None:
            counts[:, off : off + np_g] += gcount


def epilogue(scores, counts, mask, required, min_score):
    """(final [Q, L], matched [Q, L]): ``matched = (counts >= max(required,
    1) | score > 0) & mask`` and ``final`` the score where matched and at
    least ``min_score``, else ``NEG_INF``. ``mask`` is [L] (shared) or [Q,
    L]; ``required`` and ``min_score`` are [Q]. The floor is the one
    ``masked_topk`` would apply, folded in (the kernel's epilogue writes
    the same ``final``)."""
    if counts is not None:
        matched = (counts >= required.clamp_min(1.0)[:, None]) & mask
    else:
        # every scored posting weighs > 0, so score > 0 <=> a term hit
        matched = (scores > 0.0) & mask
    final = torch.where(matched & (scores >= min_score[:, None]), scores, NEG_INF)
    return final, matched


def topk_cut(final, counts, k: int):
    """(top scores [Q, k], [k ids | k counts] [Q, 2k]) of ``final``."""
    return pack_cut(*masked_topk(final, k), counts)


def pack_cut(top_s, top_i, counts):
    """(top scores, [k ids | k counts]): each hit's count, or -1
    ("unknown") without counts (an empty slot, id -1, reads column 0, as
    the reference's gather does)."""
    if counts is not None:
        top_counts = counts.gather(1, top_i.clamp_min(0)).long()
    else:
        top_counts = torch.full_like(top_i, -1)
    return top_s, torch.cat([top_i, top_counts], dim=1)


# --------------------------------------------------------------------------
# the kernel: the program table (its host half) and the launch
# --------------------------------------------------------------------------

POSTING, DENSE_SUM, DENSE_DIRECT = 0, 1, 2  # record kinds (csrc/bm25_program.cu)
# one record as the kernel reads it (struct Rec in the source), 64 bytes
REC_DTYPE = np.dtype([
    ("p0", "<i8"), ("p1", "<i8"), ("p2", "<i8"), ("dir", "<i8"),
    ("start", "<i4"), ("kind", "<i4"), ("lo", "<i4"), ("hi", "<i4"), ("n_rows", "<i4"), ("width", "<i4"),
    ("dir_t0", "<i4"), ("dir_n", "<i4"),
])
MAX_RECORDS = 500  # the table the launch's parameter holds (MAX_RECS in the source)
MAX_SLOTS = 65535  # slot columns a launch takes: a hit count fits 16 bits (MAX_SLOTS)
MAX_DENSE_SLOTS = 1024  # slot columns of one dense record (MAX_DENSE_SLOTS)
KMAX = 1024  # the largest k the kernel's cut takes; a larger k is cut by ops/topk.py
MAX_TILE_COLS = 16384  # the widest tile a block holds in shared memory (MAX_TILE)
TILE_COLS = 8192  # columns a block owns at a full batch
MIN_TILE_COLS = 2048  # the narrowest tile a small batch cuts its rows into
DIR_COLS = 2048  # columns one entry of a lane directory spans; tiles are multiples of it
DIR_MIN_WIDTH = 512  # posting tiers at least this wide get a lane directory; narrower rows are read whole
_BLOCKS_PER_SM = 3  # __launch_bounds__(THREADS, 3) in the source
_NO_DOC = 1 << 62  # a padding lane's sort key: after every doc
_TABLES_KEPT = 64  # launch tables a layout keeps by caps


class Record(NamedTuple):
    """One record of the program table: a posting tier (``tensors`` = docs
    i32, tfs f32, dls f32, each [T, W]; ``start`` the offset added to its
    doc ids) or a dense block (``tensors`` = tfs u8 [R, width], dl f32
    [width]; ``start`` the window's first score column). ``slot`` is its
    entry of ``caps``: a launch reads its slot columns from there."""

    kind: int
    slot: int
    tensors: tuple
    start: int


_POSTING_TYPES = (torch.int32, torch.float32, torch.float32)
_DENSE_TYPES = (torch.uint8, torch.float32)


def ascending_rows(docs, tfs, dls):
    """``(docs, tfs, dls, n_sorted)``: each posting row with its valid lanes
    (doc >= 0) first, in ascending doc order, its padding after them. A
    row that already is so stays; any other row's lanes are sorted by doc
    (stably, padding last) in copies of the three tensors, which gives the
    program the same result, since a row's lanes never meet at a column.
    Raises on a doc twice in one row: its lanes would meet."""
    key = torch.where(docs >= 0, docs.long(), _NO_DOC)
    if key.shape[1] < 2:
        return docs, tfs, dls, 0
    pad_pair = (key[:, 1:] == _NO_DOC) & (key[:, :-1] == _NO_DOC)
    bad = ((key[:, 1:] <= key[:, :-1]) & ~pad_pair).any(dim=1)
    idx = torch.nonzero(bad).flatten()
    if idx.numel() == 0:
        return docs, tfs, dls, 0
    sorted_key, order = torch.sort(key[idx], dim=1, stable=True)
    if bool(((sorted_key[:, 1:] == sorted_key[:, :-1]) & (sorted_key[:, 1:] != _NO_DOC)).any()):
        raise ValueError("a posting row holds a doc twice")
    out = []
    for t in (docs, tfs, dls):
        t = t.clone()
        t[idx] = t[idx].gather(1, order)
        out.append(t)
    return (*out, int(idx.numel()))


def lane_directory(docs, start: int, dir_cols: int):
    """``(directory [T, n + 1] int32, t0, n)`` of ascending posting rows
    whose doc ids land at ``doc + start``: entry j of a row counts its
    valid lanes at columns below ``(t0 + j) * dir_cols``, so a tile of
    columns ``[a * dir_cols, b * dir_cols)`` holds the row's lanes
    ``[dir[row, a - t0], dir[row, b - t0])`` (indices clamped to ``[0,
    n]``); ``t0 = start // dir_cols`` and entry ``n`` counts every valid
    lane."""
    valid = docs >= 0
    t0 = start // dir_cols
    cols = torch.where(valid, docs.long() + start, _NO_DOC)
    last = int(torch.where(valid, cols, -1).max()) if docs.numel() else -1
    n = max(0, -(-(last + 1) // dir_cols) - t0)
    bounds = (t0 + torch.arange(n + 1, device=docs.device, dtype=torch.int64)) * dir_cols
    found = torch.searchsorted(cols, bounds.expand(docs.shape[0], n + 1).contiguous())
    return found.to(torch.int32).contiguous(), t0, n


class Layout:
    """The static half of the kernel's program table: the records in the
    order the plain version adds them (posting tiers first), checked for
    what the kernel takes (contiguous tensors of the expected types on one
    device, windows that start at 0 or later) and packed as ``REC_DTYPE``
    rows. Each posting row is made ascending (``ascending_rows``: the
    tensors of a tier with a row out of order are replaced by sorted
    copies, ``n_sorted`` counts those rows), and each posting tier at least
    ``DIR_MIN_WIDTH`` wide gets a lane directory every ``DIR_COLS``
    columns (``lane_directory``), so a block finds its tile's lanes
    without reading the row. Built once per refresh (the engine's groups,
    a mesh member's arena), it holds its tensors, so its pointers stay
    valid; a launch only fills in the slot columns of its ``caps``."""

    def __init__(self, records):
        self.dir_cols = DIR_COLS
        self.records = []
        self.directories = []
        self.n_sorted = 0
        self.n_post = sum(rec.kind == POSTING for rec in records)
        if any(rec.kind == POSTING for rec in records[self.n_post:]):
            raise ValueError("posting records must precede the dense records")
        self.array = np.zeros(len(records), REC_DTYPE)
        self.slot = np.array([rec.slot for rec in records], np.int64)
        self.device = None
        self.end = 0  # the score columns the dense windows need
        self._tables = {}  # (caps, L) -> table; read by any thread, written under _tables_lock
        self._tables_lock = threading.Lock()
        for i, rec in enumerate(records):
            types = _POSTING_TYPES if rec.kind == POSTING else _DENSE_TYPES
            if len(rec.tensors) != len(types):
                raise ValueError(f"record {i}: {len(rec.tensors)} tensors, kind {rec.kind} takes {len(types)}")
            for t, dtype in zip(rec.tensors, types):
                if t.dtype != dtype or not t.is_contiguous():
                    raise ValueError(f"record {i}: a {t.dtype} tensor of shape {tuple(t.shape)} "
                                     f"(the kernel takes contiguous {dtype})")
                if self.device is None:
                    self.device = t.device
                elif t.device != self.device:
                    raise ValueError(f"record {i}: tensors on {t.device} and {self.device}")
            n_rows, width = rec.tensors[0].shape
            directory, t0, n = None, 0, 0
            if rec.kind == POSTING:
                if any(t.shape != rec.tensors[0].shape for t in rec.tensors):
                    raise ValueError(f"record {i}: docs, tfs and dls differ in shape")
                if n_rows * width >= 2**31:
                    raise ValueError(f"record {i}: a tier of {n_rows} x {width} lanes (the kernel indexes < 2^31)")
                *tensors, n_sorted = ascending_rows(*rec.tensors)
                rec = rec._replace(tensors=tuple(tensors))
                self.n_sorted += n_sorted
                if width >= DIR_MIN_WIDTH:
                    directory, t0, n = lane_directory(rec.tensors[0], rec.start, self.dir_cols)
            else:
                if rec.tensors[1].shape != (width,):
                    raise ValueError(f"record {i}: dl of shape {tuple(rec.tensors[1].shape)} for a window of {width}")
                if rec.start < 0:
                    raise ValueError(f"record {i}: a window at {rec.start}")
                self.end = max(self.end, rec.start + width)
            self.records.append(rec)
            self.directories.append(directory)
            ptrs = [t.data_ptr() for t in rec.tensors] + [0] * (3 - len(rec.tensors))
            dir_ptr = 0 if directory is None else directory.data_ptr()
            self.array[i] = (*ptrs, dir_ptr, rec.start, rec.kind, 0, 0, n_rows, width, t0, n)
        if self.device is not None:
            stream_wait(self.device)  # the sorted rows and directories are read on other threads' streams

    def table(self, caps, L: int, overlay: "Layout | None" = None) -> tuple[np.ndarray, int]:
        """(the records a launch with ``caps`` reads, their posting count):
        this layout's records, then ``overlay``'s dense ones, each with its
        slot columns; records no slot is scheduled for are left out. Kept
        for the last ``_TABLES_KEPT`` ``caps`` without an overlay (a
        request's caps repeat, and building a table costs more host time
        than a single query's kernel takes on the card)."""
        if overlay is not None:
            return self._table(caps, L, overlay)
        key = (tuple(int(c) for c in caps), int(L))
        out = self._tables.get(key)
        if out is None:
            out = self._table(caps, L, None)
            with self._tables_lock:
                if len(self._tables) >= _TABLES_KEPT:
                    self._tables.pop(next(iter(self._tables)), None)
                self._tables[key] = out
        return out

    def _table(self, caps, L: int, overlay: "Layout | None") -> tuple[np.ndarray, int]:
        parts = [self] if overlay is None else [self, overlay]
        starts = np.concatenate([[0], np.cumsum(caps, dtype=np.int64)])
        tables = []
        for lay in parts:
            if lay.slot.size and int(lay.slot.max()) >= len(caps):
                raise ValueError(f"caps {tuple(caps)} have no entry {int(lay.slot.max())}")
            if lay.end > L:
                raise ValueError(f"a dense window ends at {lay.end}, past the score space {L}")
            t = lay.array.copy()
            t["lo"] = starts[lay.slot]
            t["hi"] = starts[lay.slot + 1]
            tables.append(t[t["hi"] > t["lo"]])
        table = np.concatenate(tables)
        n_post = int((table["kind"] == POSTING).sum())
        dense_slots = table["hi"][n_post:] - table["lo"][n_post:]
        if len(table) > MAX_RECORDS or (dense_slots > MAX_DENSE_SLOTS).any():
            raise ValueError(f"{len(table)} table records or a dense record of {int(dense_slots.max(initial=0))} "
                             f"slots exceed the kernel's table ({MAX_RECORDS}, {MAX_DENSE_SLOTS})")
        return table, n_post


def group_layout(groups, offsets) -> Layout:
    """The layout of ``_bm25_groups_core``: every group's posting tiers in
    (group, tier) order, then every group's dense block (summed, then added
    into its window at the group's offset)."""
    post, dense = [], []
    for gi, (tiers, _block, _dl) in enumerate(groups):
        for tier in tiers:
            post.append(Record(POSTING, len(post), tuple(tier), int(offsets[gi])))
    for gi, (_tiers, block, dl_g) in enumerate(groups):
        if block is not None:
            dense.append(Record(DENSE_SUM, len(post) + gi, (block, dl_g), int(offsets[gi])))
    return Layout(post + dense)


def arena_layout(tiers, dense_tf, dlen) -> Layout:
    """The layout of the single-arena ``_bm25_search``: the posting tiers
    (global doc ids), then the base dense block, added slot by slot over
    the whole row."""
    out = [Record(POSTING, t, tuple(tier), 0) for t, tier in enumerate(tiers)]
    if dense_tf is not None:
        out.append(Record(DENSE_DIRECT, len(tiers), (dense_tf, dlen), 0))
    return Layout(out)


def overlay_layout(odense_tf, dlen, slot: int, odense_base) -> Layout:
    """The overlay's dense block of ``_bm25_search``, summed and added into
    the window at ``odense_base`` clamped to ``[0, n_pad - opad]``
    (``lax.dynamic_slice``), with the doc lengths of that window."""
    opad = odense_tf.shape[1]
    base = min(max(int(odense_base), 0), dlen.shape[0] - opad)
    return Layout([Record(DENSE_SUM, slot, (odense_tf, dlen[base : base + opad]), base)])


def tiling(n_queries: int, L: int, sm_count: int, dir_cols: int = DIR_COLS) -> tuple[int, int]:
    """(columns a block owns, tiles a row): ``TILE_COLS``, halved down to
    ``MIN_TILE_COLS`` while a batch gives the card fewer than
    ``_BLOCKS_PER_SM`` blocks an SM, a multiple of ``dir_cols`` and no
    wider than the row needs."""
    tile = TILE_COLS
    while tile > MIN_TILE_COLS and n_queries * -(-L // tile) < _BLOCKS_PER_SM * sm_count:
        tile //= 2
    tile = max(dir_cols, -(-tile // dir_cols) * dir_cols)
    tile = min(tile, -(-L // dir_cols) * dir_cols)
    if tile > MAX_TILE_COLS:
        raise ValueError(f"a tile of {tile} columns: the kernel holds at most {MAX_TILE_COLS}")
    return tile, -(-L // tile)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
)
_MERGE_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
)


def _ptr(t):
    return None if t is None else t.data_ptr()


_SM_COUNTS: dict = {}


def _sm_count(dev) -> int:
    """The card's SM count (asked once a device)."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SM_COUNTS:
        _SM_COUNTS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SM_COUNTS[key]


def _entry(name: str, argtypes):
    """The C entry ``name`` of the built ``csrc/bm25_program.cu``, typed."""
    fn = getattr(kernels.load("bm25_program"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch_program(layout, caps, masks, rows, idfs, params, with_counts: bool, count_only: bool, k: int = 0,
                   overlay=None):
    """One launch of ``csrc/bm25_program.cu`` for the program ``layout``
    (and ``overlay``) describe with ``caps``, on the tensors' card and its
    current stream. Returns (final, counts, matched, cut):

    - rows mode (``k`` = 0): final [Q, L] f32, counts [Q, L] f32 or None,
      matched [Q, L] bool or, under ``count_only``, [Q] int64 match
      counts, and None;
    - cut mode (1 <= ``k`` <= ``KMAX``): None, None, matched [Q, L] bool
      or, under ``count_only``, [Q, n_tiles] int64 match counts a tile,
      and the tiles' cuts (scores f32, columns int64, counts int64, each
      [Q, n_tiles, k]; counts -1 without ``with_counts``) for
      ``merge_program_cuts``."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the BM25 kernel runs on a CUDA device, not {dev}")
    n_q, n_slots = rows.shape
    L = masks.shape[-1]
    for name, t, dtype, shape in (
        ("rows", rows, torch.int32, (n_q, n_slots)), ("idfs", idfs, torch.float32, (n_q, n_slots)),
        ("params", params, torch.float32, (n_q, 3)),
        ("masks", masks, torch.bool, (L,) if masks.dim() == 1 else (n_q, L)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; "
                             f"the kernel takes contiguous {dtype} {shape} on {dev}")
    if n_q == 0 or L == 0 or n_slots == 0:
        raise ValueError(f"empty program: Q={n_q}, L={L}, S={n_slots}")
    if sum(caps) != n_slots:
        raise ValueError(f"caps {tuple(caps)} for {n_slots} slot columns")
    if not 0 <= k <= KMAX:
        raise ValueError(f"k={k}: the kernel's cut takes 1 to {KMAX} (0: rows)")
    for lay in (layout, overlay):
        if lay is not None and lay.records and lay.device != dev:
            raise ValueError(f"a table tensor is on {lay.device}, not {dev}")
    table, n_post = layout.table(caps, L, overlay)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"{n_slots} slot columns: the kernel takes at most {MAX_SLOTS}")
    tile, n_tiles = tiling(n_q, L, _sm_count(dev), layout.dir_cols)
    final = counts = part = cut = None
    if k:
        ic = torch.empty((2, n_q, n_tiles, k), dtype=torch.int64, device=dev)
        cut = (torch.empty((n_q, n_tiles, k), dtype=torch.float32, device=dev), ic[0], ic[1])
    else:
        final = torch.empty((n_q, L), dtype=torch.float32, device=dev)
        counts = torch.empty((n_q, L), dtype=torch.float32, device=dev) if with_counts else None
    matched = None if count_only else torch.empty((n_q, L), dtype=torch.bool, device=dev)
    if count_only:
        part = torch.empty((n_q, n_tiles), dtype=torch.int64, device=dev)
    fn = _entry("bm25_program", _KERNEL_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        err = fn(
            table.ctypes.data, len(table), n_post,
            rows.data_ptr(), idfs.data_ptr(), n_slots, params.data_ptr(),
            masks.data_ptr(), 0 if masks.dim() == 1 else L,
            _ptr(final), _ptr(counts), int(with_counts), _ptr(matched), _ptr(part),
            *(_ptr(t) for t in (cut or (None, None, None))), k, k,
            L, tile, layout.dir_cols, n_q, stream.cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bm25_program launch failed: CUDA error {err}")
    LAUNCHES.add("program")
    if not count_only:
        return final, counts, matched, cut
    if k:
        return None, None, part, cut
    return final, counts, part[:, 0] if n_tiles == 1 else part.sum(dim=1), None


def merge_program_cuts(cut, part, k: int):
    """One launch of ``csrc/bm25_program.cu``'s merge: the rows' cuts from
    ``launch_program``'s tile cuts ``cut``, as (top scores [Q, k], [k ids |
    k counts] [Q, 2k] int64, [Q] int64 match counts summed from ``part``
    [Q, n_tiles], or None without it)."""
    cut_s, cut_i, cut_c = cut
    n_q, n_tiles, kk = cut_s.shape
    if kk != k or not 1 <= k <= KMAX:
        raise ValueError(f"tile cuts of {kk} entries for k={k}")
    dev = cut_s.device
    top_s = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    top_ic = torch.empty((n_q, 2 * k), dtype=torch.int64, device=dev)
    match = None if part is None else torch.empty((n_q,), dtype=torch.int64, device=dev)
    fn = _entry("bm25_merge", _MERGE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(cut_s.data_ptr(), cut_i.data_ptr(), cut_c.data_ptr(), n_tiles, k, _ptr(part),
                 top_s.data_ptr(), top_ic.data_ptr(), _ptr(match), n_q, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bm25_merge launch failed: CUDA error {err}")
    LAUNCHES.add("merge")
    return top_s, top_ic, match


def merge_cuts(cut_s, cut_i, k: int):
    """A row's cut ([Q, k] scores, [Q, k] ids) from its tiles' cuts
    [Q, n_tiles, k]: each tile's list is in ``lax.top_k``'s order and
    the tiles are in column order, so a stable sort by score keeps the
    lower column first among equal scores."""
    if cut_s.shape[1] == 1:
        return cut_s[:, 0], cut_i[:, 0]
    n_q = cut_s.shape[0]
    top_s, order = torch.sort(cut_s.reshape(n_q, -1), dim=1, descending=True, stable=True)
    return top_s[:, :k], cut_i.reshape(n_q, -1).gather(1, order[:, :k])


def merge_tile_cuts(cut_s, cut_i, cut_c, k: int):
    """The plain version of the merge kernel's cut: (top scores [Q, k],
    [k ids | k counts] [Q, 2k]) from the tiles' cuts with their counts (a
    padding entry's count rides along from tile 0's list, as the kernel
    takes it)."""
    n_q = cut_s.shape[0]
    _, order = torch.sort(cut_s.reshape(n_q, -1), dim=1, descending=True, stable=True)
    top_s, top_i = merge_cuts(cut_s, cut_i, k)
    top_c = cut_c.reshape(n_q, -1).gather(1, order[:, :k])
    return top_s, torch.cat([top_i, top_c], dim=1)


def run_kernel(layout, caps, masks, rows, idfs, params, k: int, with_counts: bool, count_only: bool,
               overlay=None):
    """The program on the card: the kernel with its tiles' cuts, then the
    merge kernel (``ops/topk.py`` cuts a ``k`` past ``KMAX`` from the
    kernel's rows). Returns (top scores [Q, k], [k ids | k counts] [Q, 2k],
    matched [Q, L] or its [Q] counts)."""
    if not 1 <= k <= KMAX:
        final, counts, matched, _ = launch_program(layout, caps, masks, rows, idfs, params, with_counts, count_only,
                                                   0, overlay)
        top_s, top_ic = topk_cut(final, counts, k)
        return top_s, top_ic, matched
    _, _, matched, cut = launch_program(layout, caps, masks, rows, idfs, params, with_counts, count_only, k, overlay)
    top_s, top_ic, match = merge_program_cuts(cut, matched if count_only else None, k)
    return top_s, top_ic, match if count_only else matched


def plain_final(groups, offsets, masks, rows, idfs, params, caps, tier_counts, with_counts):
    """The plain version of what the kernel writes, torch ops on any device:
    (final [Q, L], counts [Q, L] or None, matched [Q, L])."""
    avgdl, required, min_score = params[:, 0], params[:, 1], params[:, 2]
    L = masks.shape[-1]
    parts = gather_weights(groups, offsets, rows, idfs, avgdl, caps, tier_counts, L)
    scores, counts = scatter_postings(parts, rows.shape[0], L, with_counts, masks.device)
    scores = scores[:, :L]
    counts = counts[:, :L] if counts is not None else None
    add_dense_columns(scores, counts, groups, offsets, rows, idfs, avgdl, caps, tier_counts)
    final, matched = epilogue(scores, counts, masks, required, min_score)
    return final, counts, matched


def plain_program(groups, offsets, masks, rows, idfs, params, k, caps, tier_counts, with_counts, count_only=False):
    """The plain version of the group program: what the CPU runs, and what
    the kernel is held against on the card."""
    final, counts, matched = plain_final(groups, offsets, masks, rows, idfs, params, caps, tier_counts, with_counts)
    top_s, top_ic = topk_cut(final, counts, k)
    return top_s, top_ic, matched.sum(dim=-1) if count_only else matched


def _program(groups, offsets, masks, rows, idfs, params, k, caps, tier_counts, with_counts, count_only=False,
             layout=None):
    """The kernel for tensors on a CUDA device (over ``layout``, the
    caller's ``group_layout`` of ``groups``, or one built here), the plain
    version for tensors on the CPU; there is no fallback between the two."""
    n_t = sum(tier_counts)
    if len(caps) != n_t + len(groups):
        raise ValueError(f"caps {caps} do not match {n_t} tiers and {len(groups)} groups")
    if rows.device.type == "cuda":
        if layout is None:
            layout = group_layout(groups, offsets)
        return run_kernel(layout, caps, masks, rows, idfs, params, k, with_counts, count_only)
    if rows.device.type != "cpu":
        raise ValueError(f"unsupported device {rows.device}")
    return plain_program(groups, offsets, masks, rows, idfs, params, k, caps, tier_counts, with_counts, count_only)


def bm25_groups(groups, offsets, mask, all_rows, all_idfs, params, k, caps, tier_counts, with_counts=True,
                *, layout=None):
    """One query: ``mask`` [L] bool, ``all_rows``/``all_idfs`` [sum(caps)],
    ``params`` [3] (avgdl, required, min_score). Returns (top scores [k],
    [k ids | k counts] [2k], matched [L]). ``layout``: the caller's
    ``group_layout(groups, offsets)``, kept across calls."""
    DISPATCHES.add("single")
    top_s, top_ic, matched = _program(
        groups, offsets, mask, all_rows[None], all_idfs[None], params[None],
        k, caps, tier_counts, with_counts, layout=layout,
    )
    return top_s[0], top_ic[0], matched[0]


def bm25_groups_batch(
    groups, offsets, masks, all_rows, all_idfs, params, k, caps, tier_counts,
    *, shared_mask: bool = False, count_only: bool = False, with_counts: bool = True, layout=None,
):
    """B queries in one program. ``masks`` is one shared [L] mask
    (``shared_mask``) or [B, L]; ``count_only`` returns [B] match counts
    instead of the [B, L] bitmaps; ``with_counts`` runs the hit-count
    scatter (AND semantics)."""
    if shared_mask != (masks.dim() == 1):
        raise ValueError(f"shared_mask={shared_mask} with masks of shape {tuple(masks.shape)}")
    DISPATCHES.add("batch")
    return _program(
        groups, offsets, masks, all_rows, all_idfs, params, k, caps, tier_counts, with_counts, count_only,
        layout=layout,
    )

"""The BM25 program's hand kernel (``csrc/bm25_program.cu``), its host half
on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` holds
it bit for bit against the plain version there). Here:

- the program table (``bm25.group_layout``, ``bm25.arena_layout``,
  ``bm25.overlay_layout``, ``Layout.table``) against the plain program's
  order: posting tiers in (group, tier) order with each group's offset,
  tiers and dense blocks no slot is scheduled for left out, the overlay's
  window at its clamped base, and the operands the kernel refuses;
- ``bm25.merge_cuts``: the row's cut from per-block cuts in ``lax.top_k``'s
  order (what the kernel's block cut writes) equals ``masked_topk`` of the
  whole row, ties included;
- ``bm25_groups_batch`` and ``_bm25_search_batch`` against the JAX
  package's ``_bm25_groups_batch`` and ``_bm25_search_batch`` at the cases
  the kernel must get right (a doc hit by many slots across tiers, AND
  counts with ``required`` > 1, all-padding slots, a dense window over the
  next group's docs, ``shared_mask``, ``count_only``, ``min_score``,
  thousands of equal scores): ids equal up to ties and scores within
  ``torch_test_helpers.RTOL`` (1e-5: XLA fuses ``tf + K1 * x`` on the CPU,
  torch rounds each operation), matched bitmaps, match counts and per-hit
  term counts exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucliadb_tpu.index.text_engine import engine as jeng
from nucliadb_tpu_torch.index.text_engine import engine as teng
from nucliadb_tpu_torch.ops import bm25
from nucliadb_tpu_torch.ops.topk import NEG_INF, masked_topk
from nucliadb_tpu_torch.utils import kernels
from torch_test_helpers import (
    BM25_ARENA_CASES,
    BM25_GROUP_CASES,
    assert_same_results,
    bm25_arena_case,
    bm25_group_case,
    bm25_torch_inputs,
    run_bm25_case,
)


def _jax_run(case):
    j = jnp.asarray
    flags = dict(shared_mask=case["shared_mask"], count_only=case["count_only"], with_counts=case["with_counts"])
    if "groups" in case:
        groups = tuple(
            (tuple(tuple(j(a) for a in tier) for tier in tiers), j(dense), j(dl)) for tiers, dense, dl in case["groups"]
        )
        out = jeng._bm25_groups_batch(
            groups, j(case["offsets"].astype(np.int32)), j(case["masks"]), j(case["rows"]), j(case["idfs"]),
            j(case["params"]), case["k"], case["caps"], case["tier_counts"], **flags,
        )
    else:
        out = jeng._bm25_search_batch(
            tuple(tuple(j(a) for a in tier) for tier in case["tiers"]), j(case["dense"]), j(case["odense"]),
            j(case["dlen"]), j(case["masks"]), j(case["rows"]), j(case["idfs"]), j(case["params"]), case["k"],
            case["caps"], case["odense_base"], **flags,
        )
    return tuple(np.asarray(a) for a in out)


ALL_CASES = [("group", n) for n in sorted(BM25_GROUP_CASES)] + [("arena", n) for n in sorted(BM25_ARENA_CASES)]


def _case(kind, name):
    return bm25_group_case(name) if kind == "group" else bm25_arena_case(name)


# ---------------------------------------------------------------------------
# the program table
# ---------------------------------------------------------------------------


def test_group_table_follows_the_plain_programs_order():
    """Posting tiers in (group, tier) order, each with its slot columns and
    its group's offset; a tier or dense block with no slot is left out;
    the dense blocks follow, summed then added into their windows."""
    x = bm25_torch_inputs(bm25_group_case("dense_overlap"), "cpu")
    L = x["masks"].shape[-1]
    layout = bm25.group_layout(x["groups"], x["offsets"])
    assert [r.kind for r in layout.records] == [bm25.POSTING] * 9 + [bm25.DENSE_SUM] * 3
    assert [r.slot for r in layout.records] == list(range(12))
    caps = (3, 0, 2, 0, 2, 2, 3, 2, 0) + (2, 0, 1)  # empty: tier 1 of group 0, tier 0 of group 1, tier 2 of group 2, group 1's dense
    table, n_post = layout.table(caps, L)
    starts = np.concatenate([[0], np.cumsum(caps)]).tolist()
    want = [(g, t) for g in range(3) for t in range(3) if caps[3 * g + t]]
    assert n_post == len(want)
    assert table["kind"].tolist() == [bm25.POSTING] * len(want) + [bm25.DENSE_SUM] * 2
    for row, (g, t) in zip(table, want):
        tier = x["groups"][g][0][t]
        assert (row["lo"], row["hi"]) == (starts[3 * g + t], starts[3 * g + t + 1])
        assert row["start"] == x["offsets"][g]
        assert [row["p0"], row["p1"], row["p2"]] == [a.data_ptr() for a in tier]  # ascending rows: no copy
        assert (row["n_rows"], row["width"]) == tuple(tier[0].shape)
        assert row["dir"] == 0  # narrower than DIR_MIN_WIDTH: the kernel reads the whole row
    for row, g in zip(table[len(want):], (0, 2)):
        block, dl = x["groups"][g][1], x["groups"][g][2]
        assert (row["lo"], row["hi"], row["start"]) == (starts[9 + g], starts[10 + g], x["offsets"][g])
        assert [row["p0"], row["p1"], row["p2"]] == [block.data_ptr(), dl.data_ptr(), 0]
        assert (row["n_rows"], row["width"]) == tuple(block.shape)
    # the layout is the static half: another launch's caps, the same records
    table2, _ = layout.table((1,) * 12, L)
    assert len(table2) == 12 and table2["hi"].tolist() == list(range(1, 13))
    assert bm25.REC_DTYPE.itemsize == 64 and layout.n_sorted == 0


@pytest.mark.parametrize("base,start", [(88, 80), (-5, 0), (10, 10), (80, 80)])
def test_arena_table_clamps_the_overlay_window(base, start):
    """The posting tiers with global ids (offset 0), the base dense block
    added slot by slot over the whole row, the overlay's block at its base
    clamped to [0, n_pad - opad] with the doc lengths of that window."""
    x = bm25_torch_inputs(bm25_arena_case("hot_doc_and"), "cpu")
    L = x["masks"].shape[-1]
    layout = bm25.arena_layout(x["tiers"], x["dense"], x["dlen"])
    overlay = bm25.overlay_layout(x["odense"], x["dlen"], 4, base)
    table, n_post = layout.table(x["caps"], L, overlay)
    assert n_post == 3
    assert table["kind"].tolist() == [bm25.POSTING] * 3 + [bm25.DENSE_DIRECT, bm25.DENSE_SUM]
    assert table["start"].tolist() == [0, 0, 0, 0, start]
    assert table["p1"][3] == x["dlen"].data_ptr()
    assert table["p1"][4] == x["dlen"].data_ptr() + 4 * start
    assert table["width"][4] == x["odense"].shape[1]
    # no overlay slot scheduled: no overlay record
    caps = x["caps"][:-1] + (0,)
    assert len(layout.table(caps, L, overlay)[0]) == 4


def test_layout_of_a_real_engine(tmp_path, monkeypatch):
    """A multi-group engine's own tensors (solo-built tiers, a frozen
    group's narrow tiers, every group's dense block) pass the layout's
    checks: one record a tier, then one a dense block, at the groups'
    offsets, and a planned batch's caps give a table within the score
    space. On the CPU the engine keeps no layout."""
    from nucliadb_tpu_torch.index.text_engine import builder as tbuilder
    from nucliadb_tpu_torch.types import Seq

    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    monkeypatch.setattr(teng, "FRESH_FREEZE_DOCS", 6)
    rng = np.random.default_rng(5)
    vocab = [f"w{i:02d}" for i in range(30)]
    segs = []
    for j, n in enumerate((40, 12, 9)):
        entries = [tbuilder.DocEntry(key=f"r{j}{i:03d}/f1", text=" ".join(rng.choice(vocab, 8)))
                   for i in range(n)]
        segs.append((tbuilder.open_text_segment(tbuilder.build_segment(str(tmp_path / f"s{j}"), entries,
                                                                       kind="text").path), Seq(j + 1)))
    e = teng.DeviceTextEngine(segs[:1], [], device="cpu")
    e = teng.DeviceTextEngine(segs, [], prev=e, device="cpu")
    assert len(e.groups) >= 2 and e.program_layout() is None
    layout = bm25.group_layout(e._group_tensors(), e._offsets())
    n_tiers = sum(e._tier_group_counts())
    dense = [gi for gi, g in enumerate(e.groups) if g.dense_dev is not None]
    assert [r.kind for r in layout.records] == [bm25.POSTING] * n_tiers + [bm25.DENSE_SUM] * len(dense)
    assert [r.start for r in layout.records[n_tiers:]] == [e._offsets()[gi] for gi in dense]
    k, caps, rows, idfs, params = e.plan_batch([teng.TextQuery(text=f"{vocab[i]} {vocab[i + 1]}", top_k=5)
                                                for i in range(4)])
    table, n_post = layout.table(caps, e.n_pad)
    assert 0 < n_post <= n_tiers and len(table) <= len(layout.records) and layout.end <= e.n_pad
    assert (table["hi"] > table["lo"]).all() and table["hi"].max() == rows.shape[1]


def test_table_refuses_what_the_kernel_does_not_take():
    x = bm25_torch_inputs(bm25_group_case("hot_doc"), "cpu")
    L = x["masks"].shape[-1]
    layout = bm25.group_layout(x["groups"], x["offsets"])
    layout.table(x["caps"], L)
    post, dense = layout.records[0], layout.records[-1]
    docs, tfs, dls = post.tensors
    for bad in (
        [post._replace(tensors=(docs.long(), tfs, dls))],  # docs not int32
        [post._replace(tensors=(docs, tfs.t().contiguous().t(), dls))],  # not contiguous
        [post._replace(tensors=(docs, tfs[:, :1].contiguous(), dls))],  # shapes differ
        [dense._replace(tensors=(dense.tensors[0].float(), dense.tensors[1]))],  # dense not uint8
        [dense._replace(tensors=(dense.tensors[0], dense.tensors[1][:-1]))],  # dl not the window's width
        [dense._replace(start=-1)],  # a window before column 0
        [dense, post],  # a posting record after a dense one
    ):
        with pytest.raises(ValueError):
            bm25.Layout(bad)
    # a dense window past the score space; caps with too few entries
    with pytest.raises(ValueError, match="past the score space"):
        layout.table(x["caps"], L - 9)
    with pytest.raises(ValueError, match="no entry"):
        layout.table(x["caps"][:-1], L)


def test_the_launch_takes_cuda_tensors_only(monkeypatch):
    """No fallback: the launch refuses CPU tensors, another device raises,
    and the CPU path never loads a kernel."""
    case = bm25_group_case("and_required")
    x = bm25_torch_inputs(case, "cpu")
    layout = bm25.group_layout(x["groups"], x["offsets"])
    with pytest.raises(ValueError, match="CUDA"):
        bm25.launch_program(layout, x["caps"], x["masks"], x["rows"], x["idfs"], x["params"], True, False, 12)

    def refuse(name):
        raise AssertionError(f"kernels.load({name!r}) on the CPU path")

    monkeypatch.setattr(kernels, "load", refuse)
    before = bm25.LAUNCHES.total()
    run_bm25_case(case, "cpu")
    run_bm25_case(bm25_arena_case("hot_doc_and"), "cpu")
    assert bm25.LAUNCHES.total() == before
    meta = bm25_torch_inputs(case, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bm25.bm25_groups_batch(meta["groups"], meta["offsets"], meta["masks"], meta["rows"], meta["idfs"],
                               meta["params"], 12, meta["caps"], meta["tier_counts"])


@pytest.mark.parametrize("n_q,L,chunk,n", [
    (512, 1 << 20, 8192, 128),  # a full batch: 128 tiles a query
    (1, 1 << 20, 2048, 512),  # a single query: the narrowest tiles
    (8, 136_000, 2048, 67),
    (64, 262_144, 8192, 32),  # a mesh member's arena
    (1, 100, 2048, 1),  # a row narrower than a tile: one tile of the directory's columns
])
def test_chunking(n_q, L, chunk, n):
    """``bm25.tiling``: the columns a block owns and the tiles a row."""
    assert bm25.tiling(n_q, L, 132) == (chunk, n)


@pytest.mark.parametrize("n_q,L,sms,dir_cols", [
    (512, 1 << 20, 132, 2048), (1, 1 << 20, 132, 2048), (3, 196_608, 132, 2048), (2, 21_008, 132, 2048),
    (1, 1 << 20, 132, 4096), (5, 96, 132, 16), (6, 1000, 8, 64), (7, 50_000, 1, 2048), (300, 7, 132, 1),
])
def test_tiling(n_q, L, sms, dir_cols):
    """A tile is a multiple of the lane directory's columns, within the
    kernel's shared memory, no wider than the row needs; the tiles cover
    the row; a small batch gets narrower tiles down to ``MIN_TILE_COLS``,
    no narrower than needed to give the card its blocks."""
    tile, n = bm25.tiling(n_q, L, sms, dir_cols)
    assert tile % dir_cols == 0 and 0 < tile <= bm25.MAX_TILE_COLS
    assert n == -(-L // tile) and (n - 1) * tile < L <= n * tile
    assert tile <= max(bm25.TILE_COLS, dir_cols)
    if tile > max(bm25.MIN_TILE_COLS, dir_cols) and tile >= dir_cols * -(-bm25.TILE_COLS // dir_cols):
        assert n_q * n >= bm25._BLOCKS_PER_SM * sms or tile >= L


# ---------------------------------------------------------------------------
# the lane directory and the ascending rows
# ---------------------------------------------------------------------------


def _distinct_work(case, rows):
    """numpy: the lanes of each distinct scheduled row of every posting
    tier, the valid ones, and each distinct dense row's window (1 B a
    column) plus its group's dl window (4 B a column), straight from the
    case's groups."""
    starts = np.concatenate([[0], np.cumsum(case["caps"])])
    posting = [tier for tiers, _, _ in case["groups"] for tier in tiers]
    dense = [(block, dl) for _, block, dl in case["groups"]]
    lanes = valid = dense_bytes = 0
    for slot, block in enumerate([docs for docs, _, _ in posting] + [block for block, _ in dense]):
        sel = rows[:, starts[slot] : starts[slot + 1]].ravel()
        sel = np.unique(sel[(sel >= 0) & (sel < block.shape[0])])
        if slot < len(posting):
            lanes += sel.size * block.shape[1]
            valid += int((block[sel] >= 0).sum())
        elif starts[slot + 1] > starts[slot]:
            dense_bytes += sel.size * block.shape[1] + 4 * block.shape[1]
    return {"lanes": lanes, "valid_lanes": valid, "dense_bytes": dense_bytes}


@pytest.mark.parametrize("name", sorted(BM25_GROUP_CASES))
def test_bound_reads_each_scheduled_row_once(name):
    """``chip_smoke.bm25_work`` (the BM25 program's bound) counts each
    distinct scheduled posting or dense row once a batch: the case's numpy
    count, and the same for the batch sent twice over."""
    import chip_smoke

    case = bm25_group_case(name)
    x = bm25_torch_inputs(case, "cpu")
    layout = bm25.group_layout(x["groups"], x["offsets"])
    want = _distinct_work(case, case["rows"])
    assert want["lanes"] > 0
    assert chip_smoke.bm25_work(bm25, layout, case["caps"], x["rows"]) == want
    twice = torch.cat([x["rows"], x["rows"]])
    assert chip_smoke.bm25_work(bm25, layout, case["caps"], twice) == want


def _posting_tier(rng, n_rows, width, n_docs):
    docs = np.full((n_rows, width), -1, np.int32)
    for r in range(n_rows):
        n = int(rng.integers(0, width + 1))
        docs[r, :n] = np.sort(rng.choice(n_docs, n, replace=False))
    tfs = np.where(docs >= 0, rng.integers(1, 6, docs.shape), 0).astype(np.float32)
    dls = np.where(docs >= 0, rng.integers(1, 40, docs.shape), 1).astype(np.float32)
    return docs, tfs, dls


@pytest.mark.parametrize("start,dir_cols", [(0, 16), (37, 16), (100, 64), (4096, 2048), (5, 1)])
def test_lane_directory_against_searchsorted(start, dir_cols):
    """Entry j of a row's directory is ``searchsorted`` of the row's columns
    (doc + start, valid lanes) at ``(t0 + j) * dir_cols``; the tile
    ``[a, b)`` of directory boundaries holds exactly the lanes between its
    two entries."""
    rng = np.random.default_rng(start + dir_cols)
    docs, _, _ = _posting_tier(rng, 9, 40, 300)
    directory, t0, n = bm25.lane_directory(torch.from_numpy(docs), start, dir_cols)
    assert directory.dtype == torch.int32 and directory.shape == (9, n + 1) and t0 == start // dir_cols
    valid = docs >= 0
    last = int((docs[valid] + start).max())
    assert (t0 + n) * dir_cols > last and (n == 0 or (t0 + n - 1) * dir_cols <= last)
    for r in range(9):
        cols = docs[r][valid[r]].astype(np.int64) + start
        want = np.searchsorted(cols, (t0 + np.arange(n + 1)) * dir_cols, side="left")
        np.testing.assert_array_equal(directory[r].numpy(), want)
        assert directory[r, n] == len(cols)
        for a in range(t0, t0 + n):
            lo, hi = directory[r, a - t0], directory[r, min(a + 3, t0 + n) - t0]
            in_tile = (cols >= a * dir_cols) & (cols < (a + 3) * dir_cols)
            assert np.flatnonzero(in_tile).tolist() == list(range(lo, hi))


def test_layout_builds_directories_for_wide_tiers(monkeypatch):
    """Tiers at least ``DIR_MIN_WIDTH`` wide carry a directory at the
    layout's ``DIR_COLS``, offset by their group's start; narrower tiers,
    dense blocks and the overlay carry none."""
    monkeypatch.setattr(bm25, "DIR_MIN_WIDTH", 8)
    monkeypatch.setattr(bm25, "DIR_COLS", 16)
    x = bm25_torch_inputs(bm25_group_case("dense_overlap"), "cpu")
    layout = bm25.group_layout(x["groups"], x["offsets"])
    assert layout.dir_cols == 16
    for i, rec in enumerate(layout.records):
        row = layout.array[i]
        if rec.kind != bm25.POSTING or rec.tensors[0].shape[1] < 8:
            assert row["dir"] == 0 and layout.directories[i] is None
            continue
        directory, t0, n = bm25.lane_directory(rec.tensors[0], rec.start, 16)
        assert torch.equal(layout.directories[i], directory)
        assert (row["dir"], row["dir_t0"], row["dir_n"]) == (layout.directories[i].data_ptr(), t0, n)
    assert sum(d is not None for d in layout.directories) == 6  # widths 8 and 16 of three groups


def test_layout_tables_from_threads_past_the_kept_count():
    """``Layout.table`` from 8 threads at once over 3x ``_TABLES_KEPT``
    distinct caps (its cache evicting while others read): every table
    equals one built afresh, and the cache keeps at most ``_TABLES_KEPT``."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    case = bm25_group_case("dense_overlap")
    x = bm25_torch_inputs(case, "cpu")
    layout = bm25.group_layout(x["groups"], x["offsets"])
    L = case["masks"].shape[-1]
    rng = np.random.default_rng(5)
    all_caps = {tuple(int(c) for c in rng.integers(0, 4, len(case["caps"]))) for _ in range(4 * bm25._TABLES_KEPT)}
    all_caps = sorted(all_caps)[: 3 * bm25._TABLES_KEPT]
    assert len(all_caps) == 3 * bm25._TABLES_KEPT

    def run(t):
        out = []
        for caps in all_caps[t::2] + all_caps[t::3]:
            got, n_post = layout.table(caps, L)
            want, want_post = layout._table(caps, L, None)
            out.append(n_post == want_post and got.tobytes() == want.tobytes())
        return all(out)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # a thread switch between any two bytecodes
    try:
        with ThreadPoolExecutor(8) as pool:
            assert all(pool.map(run, range(8)))
    finally:
        sys.setswitchinterval(saved)
    assert len(layout._tables) <= bm25._TABLES_KEPT


def test_layout_sorts_a_row_out_of_order():
    """A posting row out of doc order (a shuffled row, padding amid its
    lanes) is sorted once, with its tf and dl, in a copy of its tier; the
    other rows and the caller's tensors stay; the plain program gives the
    same answer over either; a doc twice in a row is refused."""
    rng = np.random.default_rng(9)
    docs, tfs, dls = _posting_tier(rng, 6, 16, 200)
    docs[1, :12] = np.sort(rng.choice(200, 12, replace=False))
    shuffled = docs.copy(), tfs.copy(), dls.copy()
    perm = rng.permutation(16)
    for a in shuffled:
        a[1] = a[1][perm]
    orig = [torch.from_numpy(a) for a in shuffled]
    got_docs, got_tfs, got_dls, n_sorted = bm25.ascending_rows(*orig)
    assert n_sorted == 1 and got_docs is not orig[0]
    np.testing.assert_array_equal(got_docs.numpy(), docs)
    np.testing.assert_array_equal(got_tfs.numpy(), tfs)
    np.testing.assert_array_equal(got_dls.numpy(), dls)
    np.testing.assert_array_equal(orig[0].numpy(), shuffled[0])  # the caller's tier is not touched
    same = bm25.ascending_rows(*(torch.from_numpy(a) for a in (docs, tfs, dls)))
    assert same[3] == 0
    layout = bm25.Layout([bm25.Record(bm25.POSTING, 0, tuple(orig), 5)])
    assert layout.n_sorted == 1 and layout.array[0]["p0"] == layout.records[0].tensors[0].data_ptr()
    np.testing.assert_array_equal(layout.records[0].tensors[0].numpy(), docs)
    # the program over the shuffled tier equals the program over the sorted one
    L = 210
    rows = torch.tensor([[1, 0, 3], [1, -1, 5]], dtype=torch.int32)
    idfs = torch.tensor([[1.5, 0.7, 2.0], [0.4, 1.0, 1.1]])
    params = torch.tensor([[12.0, 1.0, -3.0e38], [9.0, 2.0, -3.0e38]])
    mask = torch.ones(L, dtype=torch.bool)
    for with_counts in (False, True):
        want = bm25.plain_final((((tuple(torch.from_numpy(a) for a in (docs, tfs, dls)),), None, None),), (5,),
                                mask, rows, idfs, params, (3, 0), (1,), with_counts)
        got = bm25.plain_final((((tuple(orig),), None, None),), (5,), mask, rows, idfs, params, (3, 0), (1,),
                               with_counts)
        for g, w in zip(got, want):
            assert g is None and w is None or torch.equal(g, w)
    twice = docs.copy()
    twice[2, :2] = [7, 7]
    with pytest.raises(ValueError, match="twice"):
        bm25.ascending_rows(torch.from_numpy(twice), torch.from_numpy(tfs), torch.from_numpy(dls))


# ---------------------------------------------------------------------------
# the merge of the blocks' cuts, and both packages
# ---------------------------------------------------------------------------


def _block_cuts(final, chunk, k, counts=None):
    """Each tile's cut as the kernel writes it: its columns' k best real
    entries by score descending, then column ascending, padded (NEG_INF,
    -1); with ``counts`` also each entry's count (a padding entry's: the
    count at the tile's first column)."""
    n_q, L = final.shape
    n_chunks = -(-L // chunk)
    cut_s = torch.full((n_q, n_chunks, k), NEG_INF)
    cut_i = torch.full((n_q, n_chunks, k), -1, dtype=torch.int64)
    cut_c = torch.empty((n_q, n_chunks, k), dtype=torch.int64)
    for b in range(n_chunks):
        part = final[:, b * chunk : (b + 1) * chunk]
        s, order = torch.sort(part, dim=1, descending=True, stable=True)
        n = min(k, part.shape[1])
        real = s[:, :n] > NEG_INF / 2
        cut_s[:, b, :n] = torch.where(real, s[:, :n], NEG_INF)
        cut_i[:, b, :n] = torch.where(real, order[:, :n] + b * chunk, -1)
        if counts is not None:
            cut_c[:, b] = counts[:, b * chunk, None].long()
            cut_c[:, b, :n] = torch.where(real, counts.gather(1, cut_i[:, b, :n].clamp_min(0)).long(),
                                          counts[:, b * chunk, None].long())
    return (cut_s, cut_i) if counts is None else (cut_s, cut_i, cut_c)


_TILE_SHAPES = [
    (1000, 1000, 10), (1000, 128, 10), (1000, 128, 300), (50, 8, 64), (1000, 333, 1), (1000, 1000, 1000), (7, 3, 2),
    # the kernel's tiles: a row of 32,768 columns in 16 tiles of 2048 and 4 of 8192, k = 20 and KMAX
    (32_768, 2048, 20), (32_768, 8192, 20), (32_768, 2048, 1024), (20_000, 8192, 20),
]


@pytest.mark.parametrize("L,chunk,k", _TILE_SHAPES)
def test_merged_block_cuts_equal_the_whole_rows_cut(L, chunk, k):
    """Scores from a few values (thousands of ties), a third of the entries
    not kept: the merge of the tiles' cuts is ``masked_topk`` of the row,
    ids and scores, and ``pack_cut`` reads each hit's count (an empty slot's
    from column 0); ``merge_tile_cuts``, the merge kernel's plain version,
    carries the tiles' counts to the same ``[ids | counts]``."""
    rng = np.random.default_rng(L + chunk + k)
    final = torch.from_numpy(rng.integers(1, 6, (4, L)).astype(np.float32) * 0.5)
    final[torch.from_numpy(rng.random((4, L)) < 0.33)] = NEG_INF
    final[3] = NEG_INF  # a row with nothing kept
    counts = torch.from_numpy(rng.integers(0, 4, (4, L)).astype(np.float32))
    got = bm25.pack_cut(*bm25.merge_cuts(*_block_cuts(final, chunk, k), k), counts)
    want = bm25.topk_cut(final, counts, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want_s, want_i = masked_topk(final, k)
    assert torch.equal(got[1][:, :k], want_i) and (want_i[3] == -1).all()
    tiled = bm25.merge_tile_cuts(*_block_cuts(final, chunk, k, counts), k)
    assert torch.equal(tiled[0], want[0]) and torch.equal(tiled[1], want[1])


@pytest.mark.parametrize("kind,name", ALL_CASES)
def test_program_matches_reference(kind, name):
    """``bm25_groups_batch`` / ``_bm25_search_batch`` against the JAX
    package's on the same inputs."""
    case = _case(kind, name)
    js, jic, jm = _jax_run(case)
    counter = "batch" if kind == "group" else "arena_batch"
    before = bm25.DISPATCHES[counter]
    ts, tic, tm = (a.numpy() for a in run_bm25_case(case, "cpu"))
    assert bm25.DISPATCHES[counter] == before + 1
    k = case["k"]
    assert ts.shape == js.shape and tic.shape == jic.shape and tm.shape == jm.shape
    assert_same_results(js, jic[:, :k], ts, tic[:, :k])
    for q in range(len(ts)):
        assert dict(zip(tic[q, :k], tic[q, k:])) == dict(zip(jic[q, :k], jic[q, k:]))
    np.testing.assert_array_equal(tm, jm)
    assert (jic[:, :k] >= 0).sum() > 0

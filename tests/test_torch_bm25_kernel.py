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
        assert [row["p0"], row["p1"], row["p2"]] == [a.data_ptr() for a in tier]
        assert (row["n_rows"], row["width"]) == tuple(tier[0].shape)
    for row, g in zip(table[len(want):], (0, 2)):
        block, dl = x["groups"][g][1], x["groups"][g][2]
        assert (row["lo"], row["hi"], row["start"]) == (starts[9 + g], starts[10 + g], x["offsets"][g])
        assert [row["p0"], row["p1"], row["p2"]] == [block.data_ptr(), dl.data_ptr(), 0]
        assert (row["n_rows"], row["width"]) == tuple(block.shape)
    # the layout is the static half: another launch's caps, the same records
    table2, _ = layout.table((1,) * 12, L)
    assert len(table2) == 12 and table2["hi"].tolist() == list(range(1, 13))
    assert bm25.REC_DTYPE.itemsize == 48


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
    (512, 1 << 20, 1 << 20, 1),  # a full batch: a block a query
    (1, 1 << 20, 8192, 128),  # a single query: its row cut into 128 chunks
    (8, 136_000, 8000, 17),
    (64, 262_144, 65_536, 4),
    (1, 100, 100, 1),
])
def test_chunking(n_q, L, chunk, n):
    assert bm25.chunking(n_q, L, 132) == (chunk, n)


# ---------------------------------------------------------------------------
# the merge of the blocks' cuts, and both packages
# ---------------------------------------------------------------------------


def _block_cuts(final, chunk, k):
    """Each block's cut as the kernel writes it: its columns' k best real
    entries by score descending, then column ascending, padded (NEG_INF,
    -1)."""
    n_q, L = final.shape
    n_chunks = -(-L // chunk)
    cut_s = torch.full((n_q, n_chunks, k), NEG_INF)
    cut_i = torch.full((n_q, n_chunks, k), -1, dtype=torch.int64)
    for b in range(n_chunks):
        part = final[:, b * chunk : (b + 1) * chunk]
        s, order = torch.sort(part, dim=1, descending=True, stable=True)
        n = min(k, part.shape[1])
        real = s[:, :n] > NEG_INF / 2
        cut_s[:, b, :n] = torch.where(real, s[:, :n], NEG_INF)
        cut_i[:, b, :n] = torch.where(real, order[:, :n] + b * chunk, -1)
    return cut_s, cut_i


@pytest.mark.parametrize("L,chunk,k", [
    (1000, 1000, 10), (1000, 128, 10), (1000, 128, 300), (50, 8, 64), (1000, 333, 1), (1000, 1000, 1000), (7, 3, 2),
])
def test_merged_block_cuts_equal_the_whole_rows_cut(L, chunk, k):
    """Scores from a few values (thousands of ties), a third of the entries
    not kept: the merge of the blocks' cuts is ``masked_topk`` of the row,
    ids and scores, and ``pack_cut`` reads each hit's count (an empty slot's
    from column 0)."""
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

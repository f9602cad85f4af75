"""Tests of the port that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is False. This file imports no jax, so it
also runs on a machine without it; there ``tests/conftest.py`` (which
imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nucliadb_tpu_torch.ops import binary_scan, quant, slot_scan
from torch_test_helpers import CASES, assert_same_results

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.parametrize("slots", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, slots):
    """Bit-identical tables, scores and ids, and one counted launch."""
    _need_card()
    arrays = CASES[case](np.random.default_rng(12), slots)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    launches = slot_scan.LAUNCHES["top2"]
    ks, ki = slot_scan.int8_scan_slots_resident2(*args, slots=slots)
    assert slot_scan.LAUNCHES["top2"] == launches + 1
    rs, ri = slot_scan.int8_scan_slots_resident2_reference(*args, slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(ks.view(torch.int32), rs.view(torch.int32))
    assert torch.equal(ki, ri)


@pytest.mark.parametrize("d", [64, 3072, 8192])
@pytest.mark.parametrize("b", [1, 65, 2047])
@pytest.mark.parametrize("keep,slots", [(2, 32), (1, 1024)])
def test_kernel_matches_plain_version_at_edge_shapes(keep, slots, b, d):
    """The tensor-core tiling's edges: a ragged last query tile (B = 1, 65,
    2047), the narrow slot group (S = 32) and the widest table (S = 1024),
    D of one 64-byte chunk and D streamed (3072, 8192), with chip_smoke's
    planted ties and pair collisions; bit-identical, one counted launch."""
    _need_card()
    import chip_smoke

    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    q, codes, scale, mask = chip_smoke.kernel_inputs(gen, d, slots, 65536, max(b, 8), "cuda")
    args = (q[:b].contiguous(), codes, scale, mask)
    wrapper = slot_scan.int8_scan_slots_resident2 if keep == 2 else slot_scan.int8_scan_slots
    plain = slot_scan.int8_scan_slots_resident2_reference if keep == 2 else slot_scan.int8_scan_slots_top1_reference
    launches = slot_scan.LAUNCHES[f"top{keep}"]
    ks, ki = wrapper(*args, slots=slots)
    assert slot_scan.LAUNCHES[f"top{keep}"] == launches + 1
    rs, ri = plain(*args, slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(ks.view(torch.int32), rs.view(torch.int32))
    assert torch.equal(ki, ri)


def test_cuda_index_matches_cpu_index(tmp_path):
    """The same segments searched through a cuda index (kernel route) and a
    cpu index (plain route): identical candidate tables, so the same ids,
    except that near-tied exact scores may swap (cuBLAS sums in another
    order than the CPU)."""
    _need_card()
    from unittest import mock

    import nucliadb_tpu_torch.index.vector.device as tdevice
    from nucliadb_tpu_torch.types import Seq, SimpleOpenIndex
    from nucliadb_tpu_torch.index.vector import (
        Elem, VectorConfig, VectorSearcher, create_segment,
    )

    rng = np.random.default_rng(13)
    v = rng.standard_normal((3000, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128)
    elems = [Elem(key=f"r{i % 7}/f/{i}", vectors=v[i]) for i in range(3000)]
    # three copies of row 0: the default dedup must keep exactly one of four
    elems += [Elem(key=f"dup/f/{j}", vectors=v[0]) for j in range(3)]
    idx = SimpleOpenIndex(segment_list=[(create_segment(str(tmp_path / "s"), elems, cfg), Seq(1))])
    q = rng.standard_normal((5, 128)).astype(np.float32)
    q[0] = v[0] + 0.01 * q[0]
    with mock.patch.object(tdevice, "EXACT_SCAN_THRESHOLD", 256):
        gpu = VectorSearcher(cfg, idx, device="cuda")
        cpu = VectorSearcher(cfg, idx, device="cpu")
    assert torch.equal(gpu.index.codes.codes.cpu(), cpu.index.codes.codes)
    for dedup in (True, False):
        launches = slot_scan.LAUNCHES["top2"]
        gs, gi = gpu.index.search(q, 10, with_duplicates=not dedup)
        assert slot_scan.LAUNCHES["top2"] == launches + 1
        cs, ci = cpu.index.search(q, 10, with_duplicates=not dedup)
        assert_same_results(cs, ci, gs, gi)
        top = {gpu.index.keys[i] for i in gi[0]}
        n_dup = len(top & {"r0/f/0", "dup/f/0", "dup/f/1", "dup/f/2"})
        assert n_dup == (1 if dedup else 4)


def _bits_equal(got, want):
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("wrapper", ["int8_scan_slots", "int8_scan_slots_resident"])
@pytest.mark.parametrize("slots", [256, 512, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_top1_kernel_matches_plain_version(case, slots, wrapper):
    """The top-1 mode through both wrappers: bit-identical to the plain
    version, one counted launch each."""
    _need_card()
    arrays = CASES[case](np.random.default_rng(14), slots)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    launches = dict(slot_scan.LAUNCHES)
    got = getattr(slot_scan, wrapper)(*args, block_n=1024, slots=slots)
    assert slot_scan.LAUNCHES["top1"] == launches.get("top1", 0) + 1
    assert slot_scan.LAUNCHES["top2"] == launches.get("top2", 0)
    want = slot_scan.int8_scan_slots_top1_reference(*args, slots=slots)
    torch.cuda.synchronize()
    _bits_equal(got, want)


def _binary_args(rng, n, b, d=128, slots=256):
    """Codes and query parameters made by the port's own encoders from
    numpy vectors; a masked range; planted equal columns."""
    v = rng.standard_normal((n, d)).astype(np.float32)
    for pid in (100, 100 + slots, 100 + 2 * slots, 101):
        v[pid] = v[100]
    mask = np.ones(n, bool)
    mask[512:1024] = False
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[1] = v[100]
    bc = quant.BinaryCodes.encode(torch.from_numpy(v).cuda())
    params = quant.binary_query_params(torch.from_numpy(q).cuda())
    return (*params, bc.codes_t, bc.scale, bc.popcnt, bc.resid, torch.from_numpy(mask).cuda())


@pytest.mark.parametrize("b", [8, 40, 64])
@pytest.mark.parametrize("slots", [256, 1024])
def test_binary_kernel_matches_plain_version(b, slots):
    _need_card()
    args = _binary_args(np.random.default_rng(15), 4096, b, slots=slots)
    launches = binary_scan.LAUNCHES["binary"]
    got = binary_scan.binary_scan_slots(*args, dim=128, block_n=1024, slots=slots)
    assert binary_scan.LAUNCHES["binary"] == launches + 1
    want = binary_scan.binary_scan_slots_reference(*args, dim=128, slots=slots)
    torch.cuda.synchronize()
    _bits_equal(got, want)
    assert int(got[1][1, 100]) == 100  # the planted tie keeps the lower id


def test_cuda_slot_scans_from_two_threads_at_two_widths():
    """Two threads scan arenas of different widths at once, many times
    over, through the top-2 and the top-1 modes of ``int8_slot_scan.cu``
    (D = 128, resident, and 3072, streamed) and ``binary_slot_scan.cu`` (D
    = 128 and 8192: 1,344 and 65,856 bytes of shared memory): each answer
    equals its solo answer bit for bit. Each kernel instance's
    shared-memory limit is one value set for the process, so a launch of
    one width never finds it lowered by another thread's."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from nucliadb_tpu_torch.utils.platform import thread_stream

    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    int8_in = {d: chip_smoke.kernel_inputs(gen, d, 256, 65536, 64, "cuda") for d in (128, 3072)}
    bin_in = {d: _binary_args(np.random.default_rng(d), 4096, 16, d=d, slots=256) for d in (128, 8192)}
    jobs = []  # neighbours differ in width: two threads take them at once
    for keep in (2, 1):
        for d, args in int8_in.items():
            if keep == 2:
                jobs.append(lambda a=args: slot_scan.int8_scan_slots_resident2(*a, slots=256))
            else:
                jobs.append(lambda a=args: slot_scan.int8_scan_slots(*a, block_n=1024, slots=256))
    for d, args in bin_in.items():
        jobs.append(lambda a=args, d=d: binary_scan.binary_scan_slots(*a, dim=d, block_n=1024, slots=256))
    solo = [[t.cpu() for t in job()] for job in jobs]

    def run(i):
        thread_stream("cuda")
        return i % len(jobs), [t.cpu() for t in jobs[i % len(jobs)]()]  # on its stream

    with ThreadPoolExecutor(2) as pool:
        for i, got in pool.map(run, range(40 * len(jobs))):
            _bits_equal(got, solo[i])


@pytest.mark.parametrize("quantization", ["int8", "binary"])
def test_cuda_pallas_index_matches_cpu_index(tmp_path, quantization):
    """The ``pallas`` flag routes on a cuda index (kernels) and a cpu index
    (plain versions): the same results, near-tied exact scores aside. Binary
    codes are encoded on each device, so their f32 scalars may differ in the
    last place (sums in another order)."""
    _need_card()
    from unittest import mock

    import nucliadb_tpu_torch.index.vector.device as tdevice
    from nucliadb_tpu_torch.index.vector import (
        Elem, Seq, SimpleOpenIndex, VectorConfig, VectorSearcher, create_segment,
    )

    rng = np.random.default_rng(16)
    v = rng.standard_normal((3000, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128, quantization=quantization, flags=["pallas"])
    elems = [Elem(key=f"r{i % 7}/f/{i}", vectors=v[i]) for i in range(3000)]
    elems += [Elem(key=f"dup/f/{j}", vectors=v[0]) for j in range(3)]
    idx = SimpleOpenIndex(segment_list=[(create_segment(str(tmp_path / "s"), elems, cfg), Seq(1))])
    q = rng.standard_normal((100, 128)).astype(np.float32)
    q[0] = v[0] + 0.01 * q[0]
    with mock.patch.object(tdevice, "EXACT_SCAN_THRESHOLD", 256), mock.patch.object(
        slot_scan, "BLOCK_N", 512
    ), mock.patch.object(slot_scan, "SLOTS", 256), mock.patch.object(
        binary_scan, "BINARY_BLOCK_N", 512
    ):
        gpu = VectorSearcher(cfg, idx, device="cuda")
        cpu = VectorSearcher(cfg, idx, device="cpu")
        for n_queries in (5, 100):
            for dedup in (True, False):
                before = (slot_scan.LAUNCHES["top1"], binary_scan.LAUNCHES["binary"])
                gs, gi = gpu.index.search(q[:n_queries], 10, with_duplicates=not dedup)
                after = (slot_scan.LAUNCHES["top1"], binary_scan.LAUNCHES["binary"])
                kernel = quantization == "int8" or n_queries <= 64
                grown = (int(kernel and quantization == "int8"), int(kernel and quantization == "binary"))
                assert (after[0] - before[0], after[1] - before[1]) == grown
                cs, ci = cpu.index.search(q[:n_queries], 10, with_duplicates=not dedup)
                assert_same_results(cs, ci, gs, gi)
                top = {gpu.index.keys[i] for i in gi[0]}
                n_dup = len(top & {"r0/f/0", "dup/f/0", "dup/f/1", "dup/f/2"})
                assert n_dup == (1 if dedup else 4)


# ---------------------------------------------------------------------------
# the keyword leg: torch ops (ops/bm25.py, ops/topk.py), no hand kernel
# ---------------------------------------------------------------------------


def test_cuda_masked_topk_long_axis_matches_cpu():
    """The select path of ``masked_topk`` (k * 16 <= N) on the card equals
    the CPU's: scores descending, the lower index first among ties."""
    _need_card()
    from nucliadb_tpu_torch.ops.topk import masked_topk

    rng = np.random.default_rng(18)
    s = (rng.integers(0, 6, (64, 1 << 20)) * 0.25).astype(np.float32)
    s[:, rng.choice(1 << 20, 500, replace=False)] = 9.0  # a tie run straddling k
    floor = np.full((64, 1), -1.0, np.float32)
    floor[3] = 10.0
    mask = rng.random(1 << 20) > 0.05
    for k in (1, 20, 300):
        args = [torch.from_numpy(a) for a in (s, mask, floor)]
        cs, ci = masked_topk(args[0], k, mask=args[1], min_score=args[2])
        gs, gi = masked_topk(args[0].cuda(), k, mask=args[1].cuda(), min_score=args[2].cuda())
        assert torch.equal(gs.cpu(), cs) and torch.equal(gi.cpu(), ci)
        assert (ci[3] == -1).all() and (cs[0, : min(k, 475)] == 9.0).all()


def _keyword_segments(tmp_path, n=3000):
    from nucliadb_tpu_torch.index.text_engine.builder import DocEntry, build_segment
    from nucliadb_tpu_torch.index.vector import Seq

    rng = np.random.default_rng(17)
    vocab = [f"v{i:03d}x" for i in range(300)]
    ids = np.minimum(rng.zipf(1.3, size=(n, 12)) - 1, len(vocab) - 1)
    docs = [
        DocEntry(key=f"r{i:04d}/f", text=" ".join(vocab[j] for j in row), facets=["/l/tenth"] if i % 10 == 0 else [])
        for i, row in enumerate(ids)
    ]
    cuts = [0, 1300, 2600, n]
    segs = [
        (build_segment(str(tmp_path / f"s{j}"), docs[cuts[j] : cuts[j + 1]], kind="paragraph"), Seq(j + 1))
        for j in range(3)
    ]
    return segs, vocab


@pytest.mark.parametrize("need_matched", [True, False])
def test_cuda_keyword_engine_matches_cpu(tmp_path, monkeypatch, need_matched):
    """The device route of the text engine on the card against the same
    engine on the CPU: ids equal up to ties, scores within 1e-6, the same
    matched bitmaps and counts, and identical bits from two runs."""
    _need_card()
    from unittest import mock

    from nucliadb_tpu_torch.index.text_engine import engine as teng
    from nucliadb_tpu_torch.index.text_engine.builder import open_text_segment
    from nucliadb_tpu_torch.index.vector import LabelAtom, Seq
    from nucliadb_tpu_torch.ops import bm25

    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    metas, vocab = _keyword_segments(tmp_path)
    segs = [(open_text_segment(m.path), q) for m, q in metas]
    with mock.patch.object(teng, "GROUP_MIN_DOCS", 1000), mock.patch.object(teng, "TIER_WIDTHS", (8, 32, 128)):
        gpu = teng.DeviceTextEngine(segs, [("r0042/", Seq(9))], device="cuda")
        cpu = teng.DeviceTextEngine(segs, [("r0042/", Seq(9))], device="cpu")
    assert len(gpu.groups) == 3 and gpu.groups[0].dense_dev is not None
    rng = np.random.default_rng(19)
    queries = [
        teng.TextQuery(text=f"{vocab[int(rng.integers(0, 60))]} {vocab[int(rng.integers(0, 60))]} v00{i % 10}y",
                       top_k=20, fuzzy=True, all_terms=i % 3 == 0)
        for i in range(48)
    ]
    queries[5].filter = LabelAtom("/l/tenth")
    queries[6].min_score = 2.0
    queries[7].excluded = [vocab[2]]
    before = bm25.DISPATCHES["batch"]
    runs = [gpu.search_batch(queries, need_matched=need_matched) for _ in range(2)]
    assert bm25.DISPATCHES["batch"] == before + 2
    want = cpu.search_batch(queries, need_matched=need_matched)
    for (h1, m1), (h2, m2), (hc, mc) in zip(*runs, want):
        assert [(h.doc_id, h.score, h.term_count) for h in h1] == [(h.doc_id, h.score, h.term_count) for h in h2]
        assert len(h1) == len(hc)
        if hc:
            np.testing.assert_allclose([h.score for h in h1], [h.score for h in hc], rtol=1e-6)
            assert_same_results([[h.score for h in hc]], [[h.doc_id for h in hc]],
                                [[h.score for h in h1]], [[h.doc_id for h in h1]])
        if need_matched:
            np.testing.assert_array_equal(m1, mc)
            np.testing.assert_array_equal(m1, m2)
        else:
            assert m1.sum() == m2.sum() == mc.sum()
    single = gpu.search(queries[5])
    assert [h.doc_id for h in single[0]] == [h.doc_id for h in cpu.search(queries[5])[0]]



# ---------------------------------------------------------------------------
# the BM25 program's hand kernel (csrc/bm25_program.cu)
# ---------------------------------------------------------------------------


def _same_program_outputs(got, want):
    """Bit for bit: scores as int32 bits, ids and counts, matched bitmaps
    or counts."""
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            assert torch.equal(g, w)


def _bm25_cases():
    from torch_test_helpers import BM25_ARENA_CASES, BM25_GROUP_CASES

    return [("group", n) for n in sorted(BM25_GROUP_CASES)] + [("arena", n) for n in sorted(BM25_ARENA_CASES)]


@pytest.mark.parametrize("whole_rows", [False, True])
@pytest.mark.parametrize("kind,name", _bm25_cases())
def test_cuda_bm25_kernel_equals_plain_version(monkeypatch, kind, name, whole_rows):
    """``bm25_groups_batch`` and ``_bm25_search_batch`` on the card launch
    the kernel once and equal the plain version on the card bit for bit
    (with ``whole_rows``, a cut at k = L: every score of every row, by the
    kernel's tile cuts and merge up to ``bm25.KMAX`` and by ``ops/topk.py`` past
    it), with ``torch.cuda.synchronize`` made to raise."""
    _need_card()
    from nucliadb_tpu_torch.ops import bm25
    from torch_test_helpers import bm25_arena_case, bm25_group_case, run_bm25_case

    case = bm25_group_case(name) if kind == "group" else bm25_arena_case(name)
    if whole_rows:
        case["k"] = case["masks"].shape[-1]
    _refuse_synchronize(monkeypatch)
    before = bm25.LAUNCHES["program"]
    got = run_bm25_case(case, "cuda")
    assert bm25.LAUNCHES["program"] == before + 1
    want = run_bm25_case(case, "cuda", kernel=False)
    assert bm25.LAUNCHES["program"] == before + 1
    _same_program_outputs(got, want)
    _same_program_outputs(run_bm25_case(case, "cuda"), got)  # deterministic


@pytest.mark.parametrize("kind,name", _bm25_cases())
def test_cuda_bm25_kernel_rows_equal_plain_rows(kind, name):
    """One ``bm25.launch_program`` (no cut) writes the plain version's
    final rows, count rows and bitmaps or match counts, bit for bit: the
    group program against ``bm25.plain_final``, the single arena (base
    block slot by slot, the overlay at its clamped base) against
    ``engine._bm25_arena_final_plain``."""
    _need_card()
    from torch_test_helpers import bm25_arena_case, bm25_case_rows, bm25_group_case

    case = bm25_group_case(name) if kind == "group" else bm25_arena_case(name)
    got = bm25_case_rows(case, "cuda")
    want = bm25_case_rows(case, "cuda", kernel=False)
    assert (got[1] is None) == (want[1] is None)
    _same_program_outputs([t for t in got if t is not None], [t for t in want if t is not None])


# tile settings that put the kernel's tile edges inside the test cases' rows:
# tiles of 32 columns with a lane directory every 16 for every tier (each
# posting row straddles tiles; the groups' dense windows at 40 and 64, and
# the arena overlay's clamped window at 80, start mid-tile), tiles of 64
# with directories for the tiers of 8 and 16 lanes beside a narrow tier read
# whole, and tiles of 1024 (``ties_wide``'s tiles keep a few hundred entries:
# the kept list's radix select; at the default 8192, thousands: the tile's)
_TILE_SETTINGS = {
    "default": {},
    "small": dict(TILE_COLS=32, MIN_TILE_COLS=32, DIR_COLS=16, DIR_MIN_WIDTH=4),
    "mixed": dict(TILE_COLS=64, MIN_TILE_COLS=64, DIR_COLS=32, DIR_MIN_WIDTH=8),
    "medium": dict(TILE_COLS=1024, MIN_TILE_COLS=1024, DIR_COLS=512, DIR_MIN_WIDTH=8),
}


def _shuffle_rows(case, seed):
    """``case`` with the lanes of every other posting row shuffled (docs,
    tfs and dls alike): rows the ``Layout`` has to sort."""
    rng = np.random.default_rng(seed)
    tiers = [t for tiers, _, _ in case["groups"] for t in tiers] if "groups" in case else case["tiers"]
    for docs, tfs, dls in tiers:
        for r in range(0, docs.shape[0], 2):
            perm = rng.permutation(docs.shape[1])
            for a in (docs, tfs, dls):
                a[r] = a[r][perm]
    return case


@pytest.mark.parametrize("cut", ["k", "whole_rows", "past_kmax", "sorted_rows"])
@pytest.mark.parametrize("setting", ["small", "mixed", "medium"])
@pytest.mark.parametrize("kind,name", _bm25_cases())
def test_cuda_bm25_tiles_equal_plain_version(monkeypatch, kind, name, setting, cut):
    """The kernel at tiles that cut the cases' rows (``_TILE_SETTINGS``):
    posting rows straddling tile edges, dense and overlay windows starting
    mid-tile, ties of the k-th score across tiles (``ties_wide``: thousands
    of equal scores over hundreds of tiles), tiles with fewer kept entries
    than k, a k past ``bm25.KMAX`` (rows mode and ``ops/topk.py``'s cut),
    rows the ``Layout`` had to sort. The program (kernel, then merge, each
    launched once) and the kernel's rows equal the plain version bit for
    bit."""
    _need_card()
    from nucliadb_tpu_torch.ops import bm25
    from torch_test_helpers import bm25_arena_case, bm25_case_rows, bm25_group_case, run_bm25_case

    for const, value in _TILE_SETTINGS[setting].items():
        monkeypatch.setattr(bm25, const, value)
    case = bm25_group_case(name) if kind == "group" else bm25_arena_case(name)
    if cut == "whole_rows":
        case["k"] = case["masks"].shape[-1]
    elif cut == "past_kmax":
        case["k"] = bm25.KMAX + 1
    elif cut == "sorted_rows":
        case = _shuffle_rows(case, 7)
    _refuse_synchronize(monkeypatch)
    before = dict(bm25.LAUNCHES)
    got = run_bm25_case(case, "cuda")
    tile_cut = 1 <= case["k"] <= bm25.KMAX
    assert bm25.LAUNCHES["program"] == before.get("program", 0) + 1
    assert bm25.LAUNCHES["merge"] == before.get("merge", 0) + tile_cut
    _same_program_outputs(got, run_bm25_case(case, "cuda", kernel=False))
    rows = bm25_case_rows(case, "cuda")
    want = bm25_case_rows(case, "cuda", kernel=False)
    assert (rows[1] is None) == (want[1] is None)
    _same_program_outputs([t for t in rows if t is not None], [t for t in want if t is not None])


def test_cuda_bm25_merge_equals_its_plain_version():
    """The merge kernel against ``bm25.merge_tile_cuts`` on tile cuts the
    kernel wrote (a row of 32,768 columns in 16 tiles, thousands of equal
    scores, a row with nothing kept), with the match counts summed."""
    _need_card()
    from nucliadb_tpu_torch.ops import bm25

    rng = np.random.default_rng(3)
    tiers = []
    for width, n_rows in ((64, 40), (1024, 6)):
        docs = np.full((n_rows, width), -1, np.int32)
        for r in range(n_rows):
            n = int(rng.integers(1, width + 1))
            docs[r, :n] = np.sort(rng.choice(32_768, n, replace=False))
        tfs = np.where(docs >= 0, 1, 0).astype(np.float32)
        dls = np.where(docs >= 0, 10, 1).astype(np.float32)
        tiers.append(tuple(torch.from_numpy(a).cuda() for a in (docs, tfs, dls)))
    layout = bm25.arena_layout(tiers, None, None)
    rows = torch.from_numpy(rng.integers(-1, 6, (4, 8)).astype(np.int32)).cuda()
    rows[3] = -1
    idfs = torch.ones((4, 8), device="cuda")
    params = torch.tensor([[10.0, 1.0, -3.0e38]] * 4, device="cuda")
    mask = torch.ones(32_768, dtype=torch.bool, device="cuda")
    for k, with_counts in ((20, False), (20, True), (1024, True), (1, False)):
        _, _, part, cut = bm25.launch_program(layout, (4, 4), mask, rows, idfs, params, with_counts, True, k)
        top_s, top_ic, match = bm25.merge_program_cuts(cut, part, k)
        want_s, want_ic = bm25.merge_tile_cuts(*cut, k)
        _same_program_outputs((top_s, top_ic, match), (want_s, want_ic, part.sum(dim=1)))
        final, counts, matched, _ = bm25.launch_program(layout, (4, 4), mask, rows, idfs, params, with_counts,
                                                        True, 0)
        _same_program_outputs((top_s, top_ic), bm25.topk_cut(final, counts, k))
        assert torch.equal(match, matched) and int(match[3]) == 0


@pytest.mark.parametrize("setting", ["default", "small"])
def test_cuda_bm25_kernel_from_threads(monkeypatch, setting):
    """Programs of other table sizes launched from 8 threads at once (a
    node request's paragraph and document legs, the shards of
    ``search_multi``): each answer equals its solo answer bit for bit, at
    the default tiles and at tiles of 32 columns."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.utils.platform import thread_stream
    from torch_test_helpers import bm25_arena_case, bm25_group_case, run_bm25_case

    for const, value in _TILE_SETTINGS[setting].items():
        monkeypatch.setattr(bm25, const, value)

    cases = [bm25_group_case(n) for n in ("hot_doc", "and_required", "dense_overlap")] + [
        bm25_arena_case(n) for n in ("hot_doc_and", "all_padding_or")]
    solo = [run_bm25_case(c, "cuda") for c in cases]
    _refuse_synchronize(monkeypatch)

    def run(i):
        thread_stream("cuda")
        return i % len(cases), [t.cpu() for t in run_bm25_case(cases[i % len(cases)], "cuda")]  # on its stream

    with ThreadPoolExecutor(8) as pool:
        for i, got in pool.map(run, range(20 * len(cases))):
            _same_program_outputs(got, solo[i])


def test_cuda_bm25_kernel_without_a_build_raises(monkeypatch):
    """No fallback: with ``kernels.load`` made to raise, a keyword search on
    the card raises instead of running the plain version."""
    _need_card()
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.utils import kernels
    from torch_test_helpers import bm25_arena_case, bm25_group_case, run_bm25_case

    def refuse(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(kernels, "load", refuse)
    for case in (bm25_group_case("hot_doc"), bm25_arena_case("hot_doc_and")):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            run_bm25_case(case, "cuda")
    assert run_bm25_case(bm25_group_case("hot_doc"), "cpu")[0].shape[0] == 6  # the CPU takes the plain version


@pytest.mark.parametrize("setting", ["default", "small"])
def test_cuda_bm25_kernel_on_a_two_member_mesh(tmp_path, monkeypatch, setting):
    """The mesh's keyword programs on two members of the card: the text
    group (``bm25_groups`` a member) and the sharded engine
    (``_bm25_search`` a member) launch the kernel once a member and equal
    the plain version bit for bit, with ``torch.cuda.synchronize`` made to
    raise, at the default tiles and at tiles of 32 columns."""
    _need_card()
    from nucliadb_tpu_torch.ops import bm25 as bm25_ops

    for const, value in _TILE_SETTINGS[setting].items():
        monkeypatch.setattr(bm25_ops, const, value)
    from unittest import mock

    from nucliadb_tpu_torch.index.text_engine import engine as teng
    from nucliadb_tpu_torch.index.text_engine.builder import open_text_segment
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.parallel.mesh import Mesh, make_mesh
    from nucliadb_tpu_torch.parallel.text_group import MeshTextGroup
    from nucliadb_tpu_torch.parallel.text_mesh import MeshShardedTextEngine

    metas, vocab = _keyword_segments(tmp_path)
    segs = [(open_text_segment(m.path), q) for m, q in metas]
    rng = np.random.default_rng(31)
    queries = [
        teng.TextQuery(text=f"{vocab[int(rng.integers(0, 40))]} {vocab[int(rng.integers(0, 40))]}", top_k=15,
                       all_terms=i % 2 == 0)
        for i in range(6)
    ]
    with mock.patch.object(teng, "TIER_WIDTHS", (8, 32, 128)), mock.patch.object(teng, "TIER_QUERY_CAP", (4, 4, 2)):
        engines = [teng.DeviceTextEngine(segs[i : i + 1], [], device="cuda") for i in range(2)]
        assert all(len(e.groups) == 1 and e.groups[0].dense_dev is not None for e in engines)
        group = MeshTextGroup([SimpleNamespace(engine=e) for e in engines], Mesh([torch.device("cuda", 0)] * 2, ("shard",)))
        sharded = MeshShardedTextEngine(engines, make_mesh(2, device="cuda"))
        _refuse_synchronize(monkeypatch)
        before = bm25.LAUNCHES["program"]
        got = [(group.search([q, q], 15), sharded.search(q)) for q in queries]
        assert bm25.LAUNCHES["program"] == before + 4 * len(queries)
        monkeypatch.setattr(bm25, "_program", lambda *a, layout=None: bm25.plain_program(*a))
        monkeypatch.setattr(teng, "_bm25_arena", lambda *a, layout=None: teng._bm25_arena_plain(*a))
        want = [(group.search([q, q], 15), sharded.search(q)) for q in queries]
    assert bm25.LAUNCHES["program"] == before + 4 * len(queries)
    for (g_group, g_sharded), (w_group, w_sharded) in zip(got, want):
        for g, w in zip(g_group + g_sharded, w_group + w_sharded):
            assert g.dtype == w.dtype and np.array_equal(g.view(np.uint8), w.view(np.uint8))


_WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]


def _index_resources(node, sid, rng, vecs, rids):
    """Index resources ``rids`` of 100 paragraphs each (six words of
    ``_WORDS``, vector row ``r * 100 + j`` of ``vecs``) into shard ``sid``."""
    from nucliadb_tpu_torch.models.internal import IndexParagraph, ResourceDoc, TextInformation, VectorSentence

    for r in rids:
        texts = [" ".join(rng.choice(_WORDS, 6)) for _ in range(100)]
        rd = ResourceDoc(resource_id=f"r{r:03d}")
        rd.texts["t/t"] = TextInformation(text=" ".join(texts))
        paras, start = {}, 0
        for j, text in enumerate(texts):
            end = start + len(text)
            p = IndexParagraph(start=start, end=end)
            p.vectorsets_sentences["m"] = {f"r{r:03d}/t/t/{j:03d}/{start}-{end}": VectorSentence(vector=vecs[r * 100 + j])}
            paras[f"r{r:03d}/t/t/{start}-{end}"] = p
            start = end + 1
        rd.paragraphs["t/t"] = paras
        node.index(sid, rd)


def _hybrid_request(vecs, i):
    from nucliadb_tpu_torch.shard import ShardSearchRequest

    return ShardSearchRequest(body=" ".join(_WORDS[i % 8 : i % 8 + 2]), vector=vecs[i * 37 % len(vecs)],
                              top_k=10, document=True)


def _assert_same_legs(got, want):
    """Two responses of one card: every leg's hits equal up to ties within
    RTOL (another batch size may sum a rerank dot in another order)."""
    from torch_test_helpers import assert_same_ranked, plain

    g, w = plain(got)[1], plain(want)[1]
    assert_same_ranked([h[1] for h in g["vector"]], [h[1] for h in w["vector"]], lambda h: h["key"], what="vector")
    for leg, key in (("paragraph", "paragraph_id"), ("document", "key")):
        assert (g[leg] is None) == (w[leg] is None), leg
        if w[leg] is not None:
            assert_same_ranked([h[1] for h in g[leg][1]["hits"]], [h[1] for h in w[leg][1]["hits"]],
                               lambda h: h[key], what=leg)
            assert g[leg][1]["total"] == w[leg][1]["total"], leg


def test_cuda_node_matches_cpu_node(tmp_path, monkeypatch):
    """One data directory, two nodes: the card's answers equal the CPU's
    (plain versions) up to ties, and every vector leg launches the top-2
    kernel. 3,000 paragraphs take the int8 route once the threshold is
    lowered (p_pad 4,096, the top-2 scan's gate)."""
    _need_card()
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.services import EmbeddedNode

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((3000, 128)).astype(np.float32)
    nodes = {d: EmbeddedNode(str(tmp_path / "node"), device=d) for d in ("cuda", "cpu")}
    sid = nodes["cuda"].create_shard("kb", {"m": VectorConfig(dimension=128)}, shard_id="s")
    _index_resources(nodes["cuda"], sid, rng, vecs, range(30))
    nodes["cuda"].tick_background()
    launches = slot_scan.LAUNCHES["top2"]
    out = {d: [node.search(sid, _hybrid_request(vecs, i)) for i in range(16)] for d, node in nodes.items()}
    assert slot_scan.LAUNCHES["top2"] >= launches + 16
    assert nodes["cuda"].searcher.shard(sid).vectors["m"].index.codes is not None
    for a, b in zip(out["cuda"], out["cpu"]):
        assert [h.key for h in a.vector][:1] == [h.key for h in b.vector][:1]
        np.testing.assert_allclose([h.score for h in a.vector], [h.score for h in b.vector], rtol=1e-4)
        assert {h.key for h in a.vector} == {h.key for h in b.vector}
        np.testing.assert_allclose([h.score for h in a.paragraph.hits], [h.score for h in b.paragraph.hits], rtol=1e-4)
        assert a.paragraph.total == b.paragraph.total and a.document.total == b.document.total


@pytest.mark.parametrize("route", ["default", "device"])
def test_cuda_threaded_requests_wait_only_for_their_own_streams(tmp_path, monkeypatch, route):
    """Hybrid requests from 8 threads with ``torch.cuda.synchronize`` made
    to raise: no serving path waits for the whole card, every thread that
    launched ran on a stream of its own, and every answer equals its solo
    answer, on the host WAND tier and on the BM25 device program."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.services import EmbeddedNode

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    if route == "device":
        monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((3000, 128)).astype(np.float32)
    node = EmbeddedNode(str(tmp_path / "node"), device="cuda")
    sid = node.create_shard("kb", {"m": VectorConfig(dimension=128)}, shard_id="s")
    _index_resources(node, sid, rng, vecs, range(30))
    node.tick_background()
    reqs = [_hybrid_request(vecs, i) for i in range(48)]
    solo = [node.search(sid, r) for r in reqs]
    assert node.searcher.shard(sid).vectors["m"].index.codes is not None

    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize() on a serving path")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    streams = []

    def run(req):
        resp = node.search(sid, req)
        streams.append(torch.cuda.current_stream().cuda_stream)
        return resp

    launches, dispatches = slot_scan.LAUNCHES["top2"], sum(bm25.DISPATCHES.values())
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(run, reqs))
    assert slot_scan.LAUNCHES["top2"] > launches
    assert (sum(bm25.DISPATCHES.values()) > dispatches) == (route == "device")
    # the threads that led a vector dispatch launched on streams of their
    # own (a thread whose query rode another's dispatch launched nothing)
    assert len(set(streams) - {0}) > 1
    for got, want in zip(threaded, solo):
        _assert_same_legs(got, want)


def test_cuda_refresh_extends_the_arena_in_place_while_searched(tmp_path, monkeypatch):
    """A refresh writes a delta into the previous searcher's arena while
    another thread searches the previous searcher: those answers stay the
    previous searcher's, and the refreshed searcher answers as a cold open
    of the same segments."""
    _need_card()
    import threading

    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.services.searcher import SyncedSearcher

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((3500, 128)).astype(np.float32)
    node = EmbeddedNode(str(tmp_path / "node"), device="cuda")
    sid = node.create_shard("kb", {"m": VectorConfig(dimension=128)}, shard_id="s")
    _index_resources(node, sid, rng, vecs, range(30))
    node.tick_background()
    node.wait_for_sync()
    before = node.searcher.shard(sid)
    reqs = [_hybrid_request(vecs, i) for i in range(16)]
    want_before = [before.search(r) for r in reqs]
    _index_resources(node, sid, rng, vecs, range(30, 35))

    stop, seen, errors = threading.Event(), [], []

    def search_before():
        try:
            while not stop.is_set():
                for req, want in zip(reqs, want_before):
                    seen.append((before.search(req), want))
        except BaseException as exc:  # reported below
            errors.append(exc)

    reader = threading.Thread(target=search_before)
    reader.start()
    try:
        node.wait_for_sync()
    finally:
        stop.set()
        reader.join(timeout=300)
    assert not reader.is_alive() and not errors, errors
    after = node.searcher.shard(sid)
    assert after.vectors["m"].index.vectors is before.vectors["m"].index.vectors
    assert seen
    for got, want in seen:
        _assert_same_legs(got, want)
    cold = SyncedSearcher(node.metadata, node.storage, str(tmp_path / "cold"), device="cuda")
    for i in list(range(16)) + [3000 // 37 + 1, 3400 // 37]:
        req = _hybrid_request(vecs, i)
        _assert_same_legs(node.search(sid, req), cold.search(sid, req))


def test_cuda_http_find_matches_cpu_http_find(tmp_path, monkeypatch):
    """One data directory served over HTTP by two standalone apps, one on
    the card and one on the CPU: the same hybrid /find answers (the same
    top block and block set, fused and paragraph scores within 1e-4), and
    the card's vector legs launch the top-2 kernel. 3,000 paragraphs take
    the int8 route once the threshold is lowered (p_pad 4,096)."""
    _need_card()
    import nucliadb_tpu_torch.index.vector.device as device
    from torch_test_helpers import serving, standalone_app

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(9)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
    vecs = rng.standard_normal((3000, 128)).astype(np.float32)
    apps = {"cuda": standalone_app("nucliadb_tpu_torch", "cuda")(data_dir=str(tmp_path), host="127.0.0.1", port=0)}
    with serving(apps["cuda"]) as client:
        kbid = client.post("/api/v1/kbs", json={"slug": "kb", "vectorsets": {"m": {"dimension": 128}}}).json()["uuid"]
        for r in range(30):
            parts = [" ".join(rng.choice(words, 5)) for _ in range(100)]
            embeddings, start = [], 0
            for j, text in enumerate(parts):
                embeddings.append({"start": start, "end": start + len(text), "vector": vecs[r * 100 + j].tolist()})
                start += len(text) + 2
            resp = client.post(f"/api/v1/kb/{kbid}/resources", json={
                "title": f"doc {r}", "texts": {"body": {"body": "\n\n".join(parts)}},
                "embeddings": {"m": {"body": embeddings}},
            })
            assert resp.status_code == 201, resp.text
        apps["cuda"].node.tick_background()
        apps["cuda"]._sync(force=True)
        bodies = [{"query": " ".join(rng.choice(words, 2)), "vector": vecs[7 * i].tolist(), "top_k": 20}
                  for i in range(16)]
        launches = slot_scan.LAUNCHES["top2"]
        out = {"cuda": [client.post(f"/api/v1/kb/{kbid}/find", json=b).json() for b in bodies]}
        assert slot_scan.LAUNCHES["top2"] >= launches + 16
    apps["cpu"] = standalone_app("nucliadb_tpu_torch", "cpu")(data_dir=str(tmp_path), host="127.0.0.1", port=0)
    with serving(apps["cpu"]) as client:
        apps["cpu"]._sync(force=True)
        out["cpu"] = [client.post(f"/api/v1/kb/{kbid}/find", json=b).json() for b in bodies]
    for app in apps.values():
        app.stop_background()

    def scores(res):
        return {pid: p["score"] for r in res["resources"].values() for f in r["fields"].values()
                for pid, p in f["paragraphs"].items()}

    for a, b in zip(out["cuda"], out["cpu"]):
        assert a["best_matches"][:1] == b["best_matches"][:1] and set(a["best_matches"]) == set(b["best_matches"])
        sa, sb = scores(a), scores(b)
        assert sa.keys() == sb.keys()
        np.testing.assert_allclose([sa[k] for k in sb], [sb[k] for k in sb], rtol=1e-4)


def test_cuda_phase_http_rehearsal(tmp_path, monkeypatch, capsys):
    """``chip_smoke``'s /find and HTTP phases at a small size on the card:
    the HTTP answers equal the in-process ones on both keyword routes, the
    top-2 kernel launches for every vector leg served over HTTP, and the
    CLI (``--device cuda``) answers and exits cleanly."""
    _need_card()
    import chip_smoke
    from torch_test_helpers import rehearse_phase_http

    counts = rehearse_phase_http(chip_smoke, tmp_path, monkeypatch, "cuda")
    assert counts.default.get("top2", 0) >= 12 and counts.device.get("top2", 0) >= 12
    assert "its /find equal to boot B's, exited on SIGTERM" in capsys.readouterr().out


def _exact(rng, shape):
    return (rng.integers(-3, 4, shape) / 4).astype(np.float32)


def test_ivf_search_on_the_card_equals_the_cpu():
    """At D = 1,536 the int8 estimate of a query against its own row
    (every entry +-3/4, so every code +-127) is 1536 * 127**2 > 2**24: one
    f32 sum would round it, the chunked sum is exact. The layout built on
    the card and its probe scan equal the CPU's, ids and scores."""
    _need_card()
    from nucliadb_tpu_torch.ops import ivf

    rng = np.random.default_rng(21)
    n, n_pad, d = 3000, 4096, 1536
    v = _exact(rng, (n, d))
    v[:4] = np.where(rng.random((4, d)) < 0.5, -0.75, 0.75)
    q = np.concatenate([v[:4], _exact(rng, (12, d))])
    centroids = _exact(rng, (32, d))
    arena = np.zeros((n_pad, d), np.float32)
    arena[:n] = v
    out = {}
    for dev in ("cpu", "cuda"):
        a = torch.from_numpy(arena).to(dev)
        index = ivf.build_ivf(a, n, centroids=torch.from_numpy(centroids).to(dev))
        searches = ivf.SEARCHES["search"]
        s, i = ivf.ivf_search(index, a, torch.from_numpy(q).to(dev), torch.from_numpy(np.arange(n_pad) < n).to(dev),
                              -3.0e38, 10)
        assert ivf.SEARCHES["search"] == searches + 1
        out[dev] = (s.cpu().numpy(), i.cpu().numpy(), index.block_ids.cpu().numpy())
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert (out["cuda"][1][:4, 0] == np.arange(4)).all()
    codes = torch.full((2, 5, d), 127, dtype=torch.int8)
    qi = torch.full((2, d), -127, dtype=torch.int8)
    got = ivf._int8_bdot(qi.cuda(), codes.cuda()).cpu()
    assert got.dtype == torch.int32 and (got == -d * 127 * 127).all()


def test_hnsw_on_the_card_equals_the_cpu():
    """On exact data the graph built on the card (waves scanned there,
    linked on the host) and the beam search there (the visited scatter's
    -1 pads in the spare column; a filter passing 5 rows, so the loop reads
    its continue flag up to ``max_trips``) equal the CPU's."""
    _need_card()
    from nucliadb_tpu_torch.ops import hnsw

    rng = np.random.default_rng(22)
    n, n_pad = 2500, 4096
    v = _exact(rng, (n, 32))
    graphs = {dev: hnsw.build_graph(v, wave=256, seed=3, device=dev) for dev in ("cpu", "cuda")}
    for a, b in zip(graphs["cuda"], graphs["cpu"]):
        np.testing.assert_array_equal(a, b)
    adj, entry = graphs["cpu"]
    arena = np.zeros((n_pad, 32), np.float32)
    arena[:n] = v
    adj = np.pad(adj, ((0, n_pad - n), (0, 0)), constant_values=-1)
    q = _exact(rng, (16, 32))
    for allowed in (np.arange(n_pad) < n, (np.arange(n_pad) >= 100) & (np.arange(n_pad) < 105)):
        res = {}
        for dev in ("cpu", "cuda"):
            hnsw.SEARCHES.clear()
            args = [torch.from_numpy(x).to(dev) for x in (arena, adj, entry, q, allowed)]
            s, i = hnsw.hnsw_search(*args[:5], -3.0e38, 10)
            res[dev] = (s.cpu().numpy(), i.cpu().numpy(), hnsw.SEARCHES["trips"])
        np.testing.assert_array_equal(res["cuda"][1], res["cpu"][1])
        np.testing.assert_array_equal(res["cuda"][0], res["cpu"][0])
        assert res["cuda"][2] == res["cpu"][2]


def _refuse_synchronize(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.cuda.synchronize() on a serving path")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _both_devices(tmp_path, elems, cfg, budget=None):
    """A searcher on the card and one on the CPU over the same segment,
    opened under ``NDBTPU_VECTOR_ARENA_BUDGET = budget`` when given."""
    import os
    from unittest import mock

    from nucliadb_tpu_torch.index.vector import Seq, SimpleOpenIndex, VectorSearcher, create_segment

    meta = create_segment(str(tmp_path / "s"), elems, cfg, device="cpu")
    idx = SimpleOpenIndex(segment_list=[(meta, Seq(1))], deletion_list=[("r3/", Seq(2))])
    env = {"NDBTPU_VECTOR_ARENA_BUDGET": str(budget)} if budget else {}
    with mock.patch.dict(os.environ, env):
        return VectorSearcher(cfg, idx, device="cuda"), VectorSearcher(cfg, idx, device="cpu")


def test_cuda_maxsim_equals_the_cpu(tmp_path, monkeypatch):
    """MULTI on the card: on exact data (every product and sum exact in f32)
    the MaxSim answers equal the CPU's element for element, for [B, M, D]
    and [B, D] queries, masks, min_score and the slot-block dedup, with
    ``torch.cuda.synchronize`` made to raise."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig

    rng = np.random.default_rng(23)
    cfg = VectorConfig(dimension=64, cardinality="multi")
    elems = [Elem(key=f"r{i % 7}/f/{i}/0-1", vectors=_exact(rng, (int(rng.integers(1, 9)), 64)),
                  labels=["/l/a"] if i % 3 == 0 else []) for i in range(2000)]
    elems[1] = Elem(key=elems[1].key, vectors=elems[0].vectors)  # one slot block twice
    gpu, cpu = _both_devices(tmp_path, elems, cfg)
    assert gpu.index.m_max == cpu.index.m_max == 8 and gpu.index.vectors.is_cuda
    q3 = _exact(rng, (5, 4, 64))
    q3[0, :1] = elems[0].vectors[:1]
    q3[4, 3] = 0.0
    mask = rng.random(gpu.index.n_para) < 0.7
    _refuse_synchronize(monkeypatch)
    for q in (q3, q3[:, 0]):
        for kw in (dict(), dict(para_mask=mask), dict(min_score=0.5), dict(with_duplicates=False)):
            gs, gi = gpu.index.search(q, 10, **kw)
            cs, ci = cpu.index.search(q, 10, **kw)
            np.testing.assert_array_equal(gi, ci)
            np.testing.assert_array_equal(gs, cs)


def test_cuda_host_rerank_launches_the_top2_kernel(tmp_path, monkeypatch):
    """The host_rerank tier on the card takes its candidates from the top-2
    slot-scan kernel (one counted launch a search) over the host-encoded
    codes, and answers as the CPU's plain route does, with
    ``torch.cuda.synchronize`` made to raise."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig

    rng = np.random.default_rng(24)
    v = rng.standard_normal((3000, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128)
    elems = [Elem(key=f"r{i % 7}/f/{i}/0-1", vectors=v[i], labels=["/l/a"] if i % 2 else []) for i in range(3000)]
    elems += [Elem(key=f"dup/f/{j}/0-1", vectors=v[0]) for j in range(3)]
    gpu, cpu = _both_devices(tmp_path, elems, cfg, budget=4096 * (128 + 4) + 1)
    assert gpu.index.paging == cpu.index.paging == "host_rerank"
    assert torch.equal(gpu.index.codes.codes.cpu(), cpu.index.codes.codes)
    q = rng.standard_normal((6, 128)).astype(np.float32)
    q[0] = v[0] + 0.01 * q[0]
    mask = np.arange(gpu.index.n_para) % 5 != 0
    _refuse_synchronize(monkeypatch)
    for kw in (dict(), dict(with_duplicates=False), dict(para_mask=mask, min_score=0.0)):
        launches = slot_scan.LAUNCHES["top2"]
        gs, gi = gpu.index.search(q, 10, **kw)
        assert slot_scan.LAUNCHES["top2"] == launches + 1
        assert_same_results(*cpu.index.search(q, 10, **kw), gs, gi)


def test_cuda_stream_tier_equals_the_cpu(tmp_path, monkeypatch):
    """The stream tier on the card, 16 chunks each uploaded and scanned
    while the previous one's top-k is fetched, answers as the CPU does
    (ids equal; scores within the helpers' RTOL), with
    ``torch.cuda.synchronize`` made to raise."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig

    rng = np.random.default_rng(25)
    v = rng.standard_normal((4000, 256)).astype(np.float32)
    cfg = VectorConfig(dimension=256)
    elems = [Elem(key=f"r{i % 7}/f/{i}/0-1", vectors=v[i]) for i in range(4000)]
    elems += [Elem(key=f"dup/f/{j}/0-1", vectors=v[5]) for j in range(3)]
    gpu, cpu = _both_devices(tmp_path, elems, cfg, budget=256 * 256 * 4)
    assert gpu.index.paging == "stream" and gpu.index.p_pad // gpu.index.chunk_rows == 16
    q = rng.standard_normal((40, 256)).astype(np.float32)
    q[0] = v[5]
    _refuse_synchronize(monkeypatch)
    for kw in (dict(), dict(with_duplicates=False), dict(min_score=1.0)):
        assert_same_results(*cpu.index.search(q, 10, **kw), *gpu.index.search(q, 10, **kw))


def test_cuda_group_equals_sequential_with_uneven_members(tmp_path, monkeypatch):
    """The mesh vector group on a 4-member mesh of one card, over three
    shards of uneven size (p_pad 6,144, 4,096 and 12,288): each member
    launches the top-2 kernel once over its shard's own arena, and every cut
    (plain, filtered, floored, deduplicated) equals the shard's own
    ``search`` bit for bit, with ``torch.cuda.synchronize`` made to raise."""
    _need_card()
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import Elem, Seq, SimpleOpenIndex, VectorConfig, VectorSearcher, create_segment
    from nucliadb_tpu_torch.parallel.group import MeshVectorGroup
    from nucliadb_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    rng = np.random.default_rng(26)
    cfg = VectorConfig(dimension=128)
    searchers = []
    for s, n in enumerate((5000, 1200, 9000)):
        v = rng.standard_normal((n, 128)).astype(np.float32)
        v[1] = v[0]  # a duplicate for the dedup
        elems = [Elem(key=f"s{s}r{i % 7}/f/{i}/0-1", vectors=v[i], labels=["/l/a"] if i % 3 else []) for i in range(n)]
        meta = create_segment(str(tmp_path / f"s{s}"), elems, cfg, device="cpu")
        idx = SimpleOpenIndex(segment_list=[(meta, Seq(1))], deletion_list=[(f"s{s}r3/", Seq(2))])
        searchers.append(VectorSearcher(cfg, idx, device="cuda"))
    assert [vs.index.p_pad for vs in searchers] == [6144, 4096, 12288]
    group = MeshVectorGroup(searchers, Mesh([torch.device("cuda", 0)] * 4, ("shard",)))
    assert group.use_codes and group.s_pad == 4 and group.device_bytes == 0
    q = rng.standard_normal((40, 128)).astype(np.float32)
    q[0] = searchers[0].index.vectors[0].cpu().numpy()
    _refuse_synchronize(monkeypatch)
    for kw in (dict(), dict(min_score=1.0), dict(with_duplicates=False), dict(label=True)):
        masks, filt = [], []
        for vs in searchers:
            m = None
            if kw.get("label"):
                m = np.zeros(vs.index.n_para, bool)
                m[vs.index.label_postings("/l/a")] = True
            combined = vs.index.base_mask()
            if m is not None:
                combined[: m.shape[0]] &= m
            masks.append(combined)
            filt.append(m)
        opts = {k: v for k, v in kw.items() if k != "label"}
        launches = slot_scan.LAUNCHES["top2"]
        gs, gi = group.search(q, 10, masks, **opts)
        assert slot_scan.LAUNCHES["top2"] == launches + 3
        for si, vs in enumerate(searchers):
            es, ei = vs.index.search(q, 10, para_mask=filt[si], **opts)
            np.testing.assert_array_equal(gi[si], ei)
            assert np.array_equal(gs[si].view(np.int32), es.view(np.int32)), (kw, si)


def test_cuda_threaded_search_multi_on_a_two_member_mesh(tmp_path, monkeypatch):
    """``search_multi`` over two shards takes the mesh branch (the device
    listing replaced by two members of one card) from 8 threads with
    ``torch.cuda.synchronize`` made to raise: every answer equals its solo
    answer and the per-shard path's (``NDBTPU_MESH_SERVING=0``), and the
    top-2 kernel launches once a shard a request."""
    _need_card()
    from concurrent.futures import ThreadPoolExecutor

    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.parallel import mesh as pmesh
    from nucliadb_tpu_torch.services import EmbeddedNode

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    monkeypatch.setattr(pmesh, "visible_devices", lambda device="cuda": [torch.device("cuda", 0)] * 2)
    rng = np.random.default_rng(27)
    vecs = rng.standard_normal((3000, 128)).astype(np.float32)
    node = EmbeddedNode(str(tmp_path / "node"), device="cuda")
    sids = [node.create_shard("kb", {"m": VectorConfig(dimension=128)}, shard_id=f"s{i}") for i in range(2)]
    _index_resources(node, sids[0], rng, vecs, range(15))
    _index_resources(node, sids[1], rng, vecs, range(15, 30))
    node.tick_background()
    node.wait_for_sync()
    reqs = [_hybrid_request(vecs, i) for i in range(24)]
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "0")
    per_shard = [node.search_multi(sids, r) for r in reqs]
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "1")
    launches = slot_scan.LAUNCHES["top2"]
    solo = [node.search_multi(sids, r) for r in reqs]
    assert slot_scan.LAUNCHES["top2"] == launches + 2 * len(reqs)
    assert len(node.searcher._mesh_groups) == 1
    _refuse_synchronize(monkeypatch)
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(lambda r: node.search_multi(sids, r), reqs))
    for got, want, seq in zip(threaded, solo, per_shard):
        for g, w, p in zip(got, want, seq):
            _assert_same_legs(g, w)
            _assert_same_legs(g, p)


def test_cuda_mesh_over_every_visible_card(tmp_path, monkeypatch):
    """The mesh as a machine with several cards serves it, nothing replaced:
    the vector and text groups' members on ``cuda:0..n-1`` (copies of
    arenas opened on ``cuda:0``, the cuts copied back to ``cuda:0``), the
    sharded index over all cards, and ``search_multi``'s mesh branch, which
    the serving gate opens only when more than one card is visible. Every
    cut equals the shards' own searches on ``cuda:0``; on one card the mesh
    has one member and ``search_multi`` stays per shard."""
    _need_card()
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.parallel import MeshShardedVectorIndex, make_mesh
    from nucliadb_tpu_torch.parallel.group import MeshVectorGroup, mesh_serving_active
    from nucliadb_tpu_torch.services import EmbeddedNode

    n_cards = torch.cuda.device_count()
    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 1024)
    monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")  # the text group runs on the cards too
    rng = np.random.default_rng(28)
    vecs = rng.standard_normal((4800, 128)).astype(np.float32)
    node = EmbeddedNode(str(tmp_path / "node"), device="cuda")
    sids = [node.create_shard("kb", {"m": VectorConfig(dimension=128)}, shard_id=f"s{i}") for i in range(4)]
    for s in range(4):  # 1,200 paragraphs a shard: above the lowered threshold, the int8 route
        _index_resources(node, sids[s], rng, vecs, range(12 * s, 12 * s + 12))
    node.tick_background()
    node.wait_for_sync()
    assert mesh_serving_active("cuda") == (n_cards > 1)
    reqs = [_hybrid_request(vecs, i) for i in range(8)]
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "0")
    per_shard = [node.search_multi(sids, r) for r in reqs]
    monkeypatch.setenv("NDBTPU_MESH_SERVING", "1")
    launches = slot_scan.LAUNCHES["top2"]
    meshed = [node.search_multi(sids, r) for r in reqs]
    if n_cards > 1:  # the group: a launch a member (the per-shard path may coalesce)
        assert slot_scan.LAUNCHES["top2"] == launches + 4 * len(reqs)
    # the members' streams leave the thread's current card as it was, so a
    # later index on "cuda" (no index) still finds its tensors there
    assert torch.cuda.current_device() == 0
    assert len(node.searcher._mesh_groups) == int(n_cards > 1)
    assert len(node.searcher._mesh_text_groups) == int(n_cards > 1)
    for got, want in zip(meshed, per_shard):
        for g, w in zip(got, want):
            _assert_same_legs(g, w)

    searchers = [node.searcher.shard(s).vectors["m"] for s in sids]
    group = MeshVectorGroup(searchers)
    # shard_map's blocks: ceil(4 / n) members a card
    assert [d.index for d in group.devices] == [i // -(-4 // n_cards) for i in range(4)]
    q = rng.standard_normal((24, 128)).astype(np.float32)
    launches = slot_scan.LAUNCHES["top2"]
    gs, gi = group.search(q, 10, [vs.index.base_mask() for vs in searchers])
    assert slot_scan.LAUNCHES["top2"] == launches + 4
    for si, vs in enumerate(searchers):
        es, ei = vs.index.search(q, 10)
        np.testing.assert_array_equal(gi[si], ei)
        assert np.array_equal(gs[si].view(np.int32), es.view(np.int32))

    mesh = make_mesh(device="cuda")
    assert mesh.shape == {"shard": n_cards, "query": 1}
    idx = MeshShardedVectorIndex(vecs, mesh)
    s_, i_ = idx.search(q, 10)
    ref = q.astype(np.float64) @ vecs.astype(np.float64).T
    for r in range(len(q)):
        want = np.argsort(-ref[r], kind="stable")[:10]
        assert set(i_[r].tolist()) == set(want.tolist())
        np.testing.assert_allclose(s_[r], ref[r][i_[r]], rtol=1e-4)


def test_cuda_phase_cluster_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke``'s cluster phase at a small size with ``--device cuda``
    component processes: every answer over gRPC equals the in-process
    node's, and 4 equal a CPU node's within 1e-4; the answering replica
    launches the top-2 kernel for every vector leg and the other none
    until the primary is killed; the substrate process holds no CUDA
    context, the replicas do."""
    _need_card()
    import chip_smoke
    from torch_test_helpers import rehearse_phase_cluster

    out = rehearse_phase_cluster(chip_smoke, tmp_path, monkeypatch, "cuda", cpu=4)
    assert out.launches["top2"] >= 12 and out.idle["top2"] == 0
    assert out.took_over["top2"] > 0 and out.started_after > 0
    assert not out.contexts["s"]["cuda_initialized"] and not out.contexts["s"]["listed"]
    assert out.contexts["c1"]["cuda_initialized"] and out.contexts["c2"]["cuda_initialized"]



def test_cuda_phase_ops_rehearsal(tmp_path, monkeypatch, capsys):
    """``chip_smoke``'s ops phase at a small size on the card: the tool and
    the migrator answer with ``--device cuda``, the SDK's answers equal raw
    HTTP's with one top-2 launch each, every ``search.find`` span reaches
    the OTLP sink, and a node over the S3 fake answers as the local node
    with one top-2 launch a request."""
    _need_card()
    import chip_smoke
    from torch_test_helpers import rehearse_phase_ops

    out = rehearse_phase_ops(chip_smoke, tmp_path, monkeypatch, "cuda")
    assert out.sdk["top2"] == 8 and out.s3["top2"] == 8 and out.spans == 16
    assert out.served["gets"] > 0 and out.served["refused"] == 0
    assert "ops CLIs (--device cuda" in capsys.readouterr().out

def test_cuda_kernel_builds_race_safely_on_a_fresh_build_dir(tmp_path):
    """Two processes started together on a fresh build directory (a copy of
    the package, whose ``build/`` sits beside it) both build and load the
    kernels and launch the top-2 scan; they end with the same libraries
    and no partial file."""
    _need_card()
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    shutil.copytree(repo / "nucliadb_tpu_torch", tmp_path / "nucliadb_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import torch\n"
        "from nucliadb_tpu_torch.ops import slot_scan\n"
        "from nucliadb_tpu_torch.utils import kernels\n"
        "libs = [str(kernels.load(n)._name) for n in ('int8_slot_scan', 'binary_slot_scan')]\n"
        "q = torch.randint(-127, 128, (24, 128), dtype=torch.int8, device='cuda')\n"
        "codes = torch.randint(-127, 128, (4096, 128), dtype=torch.int8, device='cuda')\n"
        "scale = torch.ones(4096, device='cuda')\n"
        "mask = torch.ones(4096, dtype=torch.bool, device='cuda')\n"
        "got = slot_scan.int8_scan_slots_resident2(q, codes, scale, mask, slots=128)\n"
        "want = slot_scan.int8_scan_slots_resident2_reference(q, codes, scale, mask, slots=128)\n"
        "assert torch.equal(got[1], want[1]) and slot_scan.LAUNCHES['top2'] == 1\n"
        "print(libs)\n"
    )
    procs = [
        subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    libs = [out.strip().splitlines()[-1] for out in outs]
    assert libs[0] == libs[1] and str(tmp_path / "build" / "kernels") in libs[0], libs
    assert not list((tmp_path / "build" / "kernels").glob("*.tmp"))


# ---- the resident int8 route replayed as a captured CUDA graph -------------------


def _graph_pair(flags=(), n=20000, d=128):
    """Two copies of one int8 index on the card: ``graphed`` replays the
    resident int8 route, ``eager`` never does. A duplicate row, deletions
    and a label every third row."""
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.index.vector.device import DeviceVectorIndex
    from nucliadb_tpu_torch.utils.buckets import bucket

    rng = np.random.default_rng(31)
    p_pad = bucket(n + 1)
    arena = np.zeros((p_pad, d), np.float32)
    rows = rng.standard_normal((n, d), dtype=np.float32)
    arena[:n] = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    arena[5] = arena[2]
    alive = np.ones(n, bool)
    alive[::97] = False
    enc = quant.Int8Codes.encode(torch.from_numpy(arena))
    arrays = {"alive": alive, "para_seg": np.zeros(n, np.int32), "vectors": arena,
              "codes": enc.codes.numpy(), "scale": enc.scale.numpy()}
    cfg = VectorConfig(dimension=d, similarity="cosine", quantization="int8", flags=list(flags))
    meta = {"field": "/f/f", "split": "", "position": {"start": 0, "end": 1, "page_number": 0}}
    labels = {"/l/a": np.arange(0, n, 3, dtype=np.int32)}

    def build():
        return DeviceVectorIndex.from_reference_state(
            cfg, [f"r{i}/f/f/0-1" for i in range(n)], [meta] * n, labels, [frozenset()], [(0, n)],
            arrays, device="cuda",
        )

    graphed, eager = build(), build()
    eager._graphed = lambda: False
    assert graphed._graphed() and graphed.codes is not None
    return graphed, eager, arena[:n]


def _near(rows, b, seed):
    rng = np.random.default_rng(seed)
    q = rows[rng.integers(0, rows.shape[0], b)]
    return q + 0.3 * rng.standard_normal(q.shape, dtype=np.float32) / np.sqrt(q.shape[1])


def _bits_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))


@pytest.mark.parametrize("floor", [None, 0.3])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
def test_cuda_replayed_route_equals_eager_bit_for_bit(monkeypatch, dedup, filtered, floor):
    """Replays of the captured route answer as the eager route does, bit for
    bit, at b in {1, 7, 8, 9, 33, 2048} and top_k in {10, 100}, with
    ``torch.cuda.synchronize`` made to raise; one capture a key up to 64
    padded rows, the batch of 2048 eager; one top-2 launch counted a call."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair()
    mask = (np.arange(rows.shape[0]) % 2 == 0) if filtered else None
    kw = dict(para_mask=mask, min_score=floor, with_duplicates=not dedup)
    _refuse_synchronize(monkeypatch)
    graphs.GRAPHS.clear()
    calls = 0
    for b in (1, 7, 8, 9, 33, 2048):
        for top_k in (10, 100):
            for rep in range(3):
                q = _near(rows, b, 1000 * b + 10 * top_k + rep)
                launches = slot_scan.LAUNCHES["top2"]
                got = graphed.search(q, top_k, **kw)
                assert slot_scan.LAUNCHES["top2"] == launches + 1
                _bits_same(got, eager.search(q, top_k, **kw))
                calls += 1
    keys = 3 * 2  # b_pad 8, 12, 48 by top_k 10, 100
    eager_calls = keys + 3 * 2  # each key's first call, and b_pad 2048
    assert graphs.GRAPHS == {"capture": keys, "eager": eager_calls, "replay": calls - eager_calls}
    assert sorted(graphed._graphs.sizes().values()) == [1] * keys


def test_cuda_replayed_buckets_interleave_on_one_thread(monkeypatch):
    """Batches of 8, 2048, 8, 16, 2048, 16, 8 rows from one thread: two
    captures, each later call of 8 or 16 rows a replay of its bucket, the
    batches of 2048 eager, every answer the eager route's bit for bit."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair()
    _refuse_synchronize(monkeypatch)
    graphs.GRAPHS.clear()
    for n, b in enumerate((8, 2048, 8, 16, 2048, 16, 8)):
        q = _near(rows, b, 50 + n)
        _bits_same(graphed.search(q, 10), eager.search(q, 10))
    assert graphs.GRAPHS == {"capture": 2, "eager": 4, "replay": 3}


def test_cuda_replayed_pallas_route_equals_eager(monkeypatch):
    """The ``pallas`` flag's route (the top-1 slot scan) replays too: bit
    for bit, one top-1 launch counted a call."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair(flags=("pallas",))
    _refuse_synchronize(monkeypatch)
    graphs.GRAPHS.clear()
    for n, (b, kw) in enumerate([(5, {}), (5, {}), (40, dict(min_score=0.2)), (40, dict(min_score=0.5))]):
        q = _near(rows, b, 70 + n)
        launches = slot_scan.LAUNCHES["top1"]
        got = graphed.search(q, 10, **kw)
        assert slot_scan.LAUNCHES["top1"] == launches + 1
        _bits_same(got, eager.search(q, 10, **kw))
    assert graphs.GRAPHS == {"capture": 2, "eager": 2, "replay": 2}


def test_cuda_coalesced_threads_replay_while_a_fifth_captures(monkeypatch):
    """Four threads send 100 coalesced queries each while a fifth searches
    twenty new keys (each a capture), with ``torch.cuda.synchronize`` made
    to raise: every answer equals its solo eager answer bit for bit, the
    coalesced key holds at most ``PER_KEY`` replays, and most dispatches
    replay."""
    _need_card()
    import threading

    from nucliadb_tpu_torch.index.vector import VectorSearcher, VectorSearchRequest, batcher, graphs

    graphed, eager, rows = _graph_pair()
    searcher = VectorSearcher.__new__(VectorSearcher)
    searcher.index, searcher.config = graphed, graphed.config
    qs = _near(rows, 400, 90)
    # a VectorSearchRequest drops duplicates by default
    want = [eager.search(q[None], 10, with_duplicates=False) for q in qs]
    side = [(top_k, _near(rows, 3, 200 + top_k)) for top_k in range(11, 31)]
    side_want = [eager.search(q, top_k) for top_k, q in side]
    coalescer = batcher.QueryCoalescer(concurrency=4)
    _refuse_synchronize(monkeypatch)
    graphs.GRAPHS.clear()
    got, side_got, errors = [None] * 400, [], []

    def client(t):
        try:
            for j in range(t * 100, t * 100 + 100):
                got[j] = coalescer.search_one(searcher, VectorSearchRequest(vectors=qs[j], top_k=10))
        except BaseException as exc:  # reported below
            errors.append(exc)

    def capturer():
        try:
            for top_k, q in side:
                side_got.append(graphed.search(q, top_k))
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    threads.append(threading.Thread(target=capturer))
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    assert not errors, errors
    for hits, (s, i) in zip(got, want):
        keep = i[0] >= 0
        assert [h.key for h in hits] == [graphed.keys[p] for p in i[0][keep]]
        assert np.array_equal(np.array([h.score for h in hits], np.float32).view(np.int32),
                              s[0][keep].view(np.int32))
    for g, w in zip(side_got, side_want):
        _bits_same(g, w)
    sizes = graphed._graphs.sizes()
    assert 1 <= sizes.pop(graphs.key_of(8, 10, True, False, False)) <= graphs.PER_KEY
    assert sizes == {graphs.key_of(8, k, False, False, False): 1 for k in range(11, 31)}
    assert graphs.GRAPHS["capture"] >= 21
    assert graphs.GRAPHS["replay"] >= coalescer.dispatches // 2


def test_cuda_capture_leaves_a_thread_sharing_the_callers_stream_alone(monkeypatch):
    """PyTorch hands out its pool's 32 streams a device in turn, so two
    threads can share a stream: a thread that launches and waits on the
    searching thread's stream all through twenty captures keeps its own
    results, and every capture holds."""
    _need_card()
    import threading

    from nucliadb_tpu_torch.index.vector import graphs
    from nucliadb_tpu_torch.utils.platform import thread_stream

    graphed, eager, rows = _graph_pair()
    stream = thread_stream("cuda")
    stop, sums, errors = threading.Event(), [], []

    def neighbour():
        try:
            torch.cuda.set_stream(stream)
            x = torch.arange(1000, device="cuda", dtype=torch.float32)
            while not stop.is_set():
                sums.append((x * 2).sum().item())
        except BaseException as exc:  # reported below
            errors.append(exc)

    graphs.GRAPHS.clear()
    th = threading.Thread(target=neighbour)
    th.start()
    try:
        for top_k in range(10, 30):
            q = _near(rows, 3, 400 + top_k)
            _bits_same(graphed.search(q, top_k), eager.search(q, top_k))
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not errors, errors
    assert sums and set(sums) == {999000.0}
    assert graphs.GRAPHS == {"capture": 20, "eager": 20}


def test_cuda_replays_keep_the_mask_they_were_captured_with(monkeypatch):
    """Four threads make the index's lazy base mask at once, so three of the
    masks they capture with are not the one the index keeps; each replay
    holds its own, so once the losers' memory could be handed out again (and
    is, to all-False masks), every replay still answers as the eager route
    does, with no deleted row."""
    _need_card()
    import threading

    from nucliadb_tpu_torch.index.vector import graphs
    from nucliadb_tpu_torch.index.vector.device import DeviceVectorIndex

    graphed, eager, rows = _graph_pair()
    barrier = threading.Barrier(4, timeout=60)
    made = DeviceVectorIndex.base_mask_device

    def racing(self):
        if self is graphed and self._base_mask_dev is None:
            barrier.wait()
        return made(self)

    monkeypatch.setattr(DeviceVectorIndex, "base_mask_device", racing)
    qs = [_near(rows, b, 500 + b) for b in (3, 12, 40, 60)]  # b_pad 8, 12, 48, 64
    errors, held = [], []

    def first(q):
        try:
            graphed.search(q, 10)
            held.append(torch.zeros(graphed.p_pad, dtype=torch.bool, device="cuda"))
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=first, args=(q,)) for q in qs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not errors, errors
    monkeypatch.undo()
    deleted = np.flatnonzero(~graphed.alive)
    for rep in range(3):
        for b in (3, 12, 40, 60):
            q = _near(rows, b, 600 + 10 * b + rep)
            got = graphed.search(q, 10)
            _bits_same(got, eager.search(q, 10))
            assert not np.isin(got[1], deleted).any()


def test_cuda_a_failed_capture_answers_and_runs_its_key_eagerly(monkeypatch):
    """A route that waits for the host inside its capture (refused while a
    stream captures): the call answers from its eager run, its key runs
    eagerly from then on, and the index then captures and replays another
    key as usual."""
    _need_card()
    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair()
    route = graphed._int8_route()

    def waiting(*args):
        out = route(*args)
        out[0].sum().item()
        return out

    monkeypatch.setattr(graphed, "_int8_route", lambda: waiting)
    graphs.GRAPHS.clear()
    q = _near(rows, 4, 300)
    for _ in range(3):
        _bits_same(graphed.search(q, 10), eager.search(q, 10))
    assert graphs.GRAPHS == {"eager": 3}
    monkeypatch.setattr(graphed, "_int8_route", lambda: route)
    for _ in range(2):
        _bits_same(graphed.search(q, 20), eager.search(q, 20))
    assert graphs.GRAPHS == {"eager": 4, "capture": 1, "replay": 1}


def test_cuda_concurrent_replays_answer_as_their_solo_calls(monkeypatch):
    """Four threads search at once, each through batches of 40, 64, 200 and
    2048 rows at top_k 100 with the duplicate cut (the replayed buckets
    first captured, then replayed at once, beside the eager batches): every
    answer equals its solo eager answer bit for bit, and each graph was
    captured on a stream of its own."""
    _need_card()
    import threading

    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair()
    _refuse_synchronize(monkeypatch)
    sizes = (40, 64, 200, 2048)
    calls = [(t, j, _near(rows, sizes[(t + j) % 4], 2000 + 10 * t + j)) for t in range(4) for j in range(12)]
    want = {(t, j): eager.search(q, 100, with_duplicates=False) for t, j, q in calls}
    errors = []

    def concurrently():
        got, barrier = {}, threading.Barrier(4, timeout=60)

        def client(t):
            try:
                barrier.wait()
                for u, j, q in calls:
                    if u == t:
                        got[(t, j)] = graphed.search(q, 100, with_duplicates=False)
            except BaseException as exc:  # reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
        return got

    for _ in range(2):  # the replays each key needs at four threads, captured
        concurrently()
    graphs.GRAPHS.clear()
    got = concurrently()
    assert not errors, errors
    for key, w in want.items():
        _bits_same(got[key], w)
    assert graphs.GRAPHS["replay"] >= 12 and graphs.GRAPHS["eager"] >= 24
    assert graphs.GRAPHS["replay"] + graphs.GRAPHS["eager"] == len(calls)
    kept = [r for free in graphed._graphs._free.values() for r in free]
    assert len({r.stream.cuda_stream for r in kept}) == len(kept) > 2  # a stream, so a workspace, each


def test_cuda_graphs_hold_at_most_their_memory_share(monkeypatch):
    """Thirty-two keys at the largest replayed shapes (b_pad 48 and 64, top_k
    100 and 128, duplicate cut, filter and floor on and off) with the card's
    share set to 64 MiB: the graphs' count stops within one replay of the
    share, the calls past it run eagerly and answer bit for bit, the memory
    PyTorch reserves grows by no more than the count, and dropping the
    index gives the graphs' memory back to the count."""
    _need_card()
    import gc

    from nucliadb_tpu_torch.index.vector import graphs

    graphed, eager, rows = _graph_pair()
    gc.collect()
    graphs.settle()
    dev = torch.cuda.current_device()
    held_before = graphs._BYTES.get(dev, 0)
    share = held_before + (64 << 20)
    monkeypatch.setitem(graphs._LIMITS, dev, share)
    _refuse_synchronize(monkeypatch)
    mask = np.arange(rows.shape[0]) % 2 == 0
    calls = [
        (b, top_k, dict(para_mask=mask if f else None, min_score=0.3 if fl else None, with_duplicates=not d))
        for b in (40, 60) for top_k in (100, 128) for d in (False, True) for f in (False, True) for fl in (False, True)
    ]
    # the eager route's own intermediates are cached first, so that what
    # grows below is the graphs'
    for b, top_k, kw in calls:
        eager.search(_near(rows, b, 1), top_k, **kw)
    reserved = torch.cuda.memory_reserved()
    graphs.GRAPHS.clear()
    for n, (b, top_k, kw) in enumerate(calls):
        for rep in range(2):
            q = _near(rows, b, 900 + 10 * n + rep)
            _bits_same(graphed.search(q, top_k, **kw), eager.search(q, top_k, **kw))
    kept = [r for free in graphed._graphs._free.values() for r in free]
    largest = max(r.bytes for r in kept)
    held = graphs._BYTES[dev]
    assert share <= held <= share + largest + (1 << 25), (held, share, largest)  # and a new stream's workspace
    assert graphs.GRAPHS["eager"] > len(kept) and 0 < graphs.GRAPHS["capture"] == len(kept) < len(calls)
    assert torch.cuda.memory_reserved() - reserved <= held - held_before + (16 << 20)
    captured = graphs.GRAPHS["capture"]
    del graphed, kept
    gc.collect()
    graphs.settle()
    assert len(graphs._STREAMS[dev]) >= captured
    assert graphs._BYTES[dev] <= held_before + len(graphs._STREAMS[dev]) * (1 << 25)

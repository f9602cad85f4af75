"""Tests of the port that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is False. This file imports no jax, so it
also runs on a machine without it; there ``tests/conftest.py`` (which
imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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

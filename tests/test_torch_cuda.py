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

"""Inputs and checks shared by the port's CPU and CUDA tests (numpy only,
so the CUDA tests run where jax is not installed)."""

import contextlib
import dataclasses
import enum
import importlib

import numpy as np

# f32 sums taken in another order (another BLAS, the card) differ by a few
# ulps; scores compare within this, and ids inside runs of reference scores
# this close compare as sets
RTOL = 1e-5


def _quantize(q):
    qs = np.maximum(np.abs(q).max(-1), 1e-12) / 127.0
    return np.clip(np.round(q / qs[:, None]), -127, 127).astype(np.int8)


def _top2_oracle(rng, slots):
    """tests/test_pallas_scan.py:107 — random codes, every 7th masked."""
    n, d, b = 4096, 128, 24
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::7] = False
    q = _quantize(rng.standard_normal((b, d)).astype(np.float32))
    return q, codes, scale, mask


def _pair_collisions(rng, slots):
    """tests/test_pallas_scan.py:152 — the true top-10 planted as pairs
    (j, j + slots) that share slot j."""
    n, d, b = 4096, 128, 8
    codes = rng.integers(-40, 40, (n, d)).astype(np.int8)
    q = _quantize(rng.standard_normal((b, d)).astype(np.float32))
    for j in range(5):
        for pid in (j * 31, j * 31 + slots):
            codes[pid] = np.clip(np.sign(q[0]) * 90, -127, 127).astype(np.int8)
    return q, codes, np.ones(n, np.float32), np.ones(n, bool)


def _all_masked(rng, slots):
    """tests/test_pallas_scan.py:203 — nothing eligible."""
    n, d, b = 4096, 128, 8
    codes = np.ones((n, d), np.int8)
    q = _quantize(np.ones((b, d), np.float32))
    return q, codes, np.ones(n, np.float32), np.zeros(n, bool)


def _planted_ties(rng, slots):
    """Duplicate code rows (equal scores) at ids in the same slot and across
    slots and column blocks, plus a fully masked block of 2048 columns."""
    n, d, b = 6144, 128, 12
    codes = rng.integers(-127, 128, (n, d)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = rng.random(n) > 0.1
    mask[2048:4096] = False
    hot = np.clip(rng.standard_normal(d) * 200, -127, 127).astype(np.int8)
    # same slot: 5, 5 + S, 5 + 3S, 5 + 5000 // S * S; across slots: 6, 700
    same_slot = [5, 5 + slots, 5 + 3 * slots, 5 + (5000 // slots) * slots]
    for pid in same_slot + [6, 700, 4100]:
        codes[pid] = hot
        scale[pid] = 1.0
        mask[pid] = True
    q = np.tile(hot, (b, 1))
    q[1::2] = _quantize(rng.standard_normal((b // 2, d)).astype(np.float32))
    return q, codes, scale, mask


CASES = {
    "top2_oracle": _top2_oracle,
    "pair_collisions": _pair_collisions,
    "all_masked": _all_masked,
    "planted_ties": _planted_ties,
}


def assert_same_results(ref_s, ref_i, got_s, got_i):
    """Row by row: equal ids, scores within RTOL; inside a run of reference
    scores that lie within RTOL of each other, equal id sets."""
    ref_s, got_s = np.asarray(ref_s, np.float64), np.asarray(got_s, np.float64)
    ref_i, got_i = np.asarray(ref_i, np.int64), np.asarray(got_i, np.int64)
    assert ref_i.shape == got_i.shape
    np.testing.assert_array_equal(got_i < 0, ref_i < 0)
    valid = ref_i >= 0
    np.testing.assert_allclose(got_s[valid], ref_s[valid], rtol=RTOL, atol=1e-6)
    for row in range(ref_i.shape[0]):
        n = int(valid[row].sum())
        start = 0
        for pos in range(1, n + 1):
            if pos == n or not np.isclose(ref_s[row, pos], ref_s[row, pos - 1], rtol=RTOL, atol=1e-6):
                want = set(ref_i[row, start:pos].tolist())
                assert set(got_i[row, start:pos].tolist()) == want, (row, start, pos)
                start = pos


def as_port(obj):
    """``obj`` with every instance of a class of the JAX package rebuilt as
    the port's class of the same module path and name, field by field:
    ``types``, ``query_language`` and ``models.internal`` (a ``ResourceDoc``
    tree), the JSON expressions of ``index.json``, the graph requests of
    ``index.relation``, ``shard.ShardSearchRequest`` (with its filters and
    nested requests) and so on. A pydantic model of ``models.api`` is
    dumped to plain data by alias (``RelationPayload.from_`` travels as
    "from"), with only the fields that were set, and validated into the
    port's model. Containers are rebuilt, other values (numpy arrays among
    them) kept.

    The port keeps its own copies of those modules, so their classes and
    enums are distinct: ``evaluate_bitset`` dispatches on ``isinstance``
    and the enums compare by identity, and an object of one package would
    be mis-read by the other. A test that builds one input for both hands
    the port ``as_port(input)``."""
    cls = type(obj)
    if cls.__module__.startswith("nucliadb_tpu."):
        port = importlib.import_module("nucliadb_tpu_torch" + cls.__module__[len("nucliadb_tpu"):])
        port_cls = getattr(port, cls.__qualname__)
        if isinstance(obj, enum.Enum):
            return port_cls[obj.name]
        if dataclasses.is_dataclass(obj):
            return port_cls(**{f.name: as_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
        if hasattr(cls, "model_validate"):  # pydantic: unset fields stay unset
            return port_cls.model_validate(obj.model_dump(mode="json", by_alias=True, exclude_unset=True))
        raise TypeError(f"cannot rebuild {cls.__module__}.{cls.__qualname__} as the port's")
    if isinstance(obj, dict):
        return {as_port(k): as_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return cls(as_port(x) for x in obj)
    return obj


def plain(obj):
    """A structure of builtins that compares equal across the two packages:
    a dataclass becomes (class name, {field: plain(value)}), an enum its
    name, a numpy array its list, containers are rebuilt (sets as sorted
    lists) and floats are kept, so ``assert_plain_close`` can hold them
    within a tolerance."""
    if isinstance(obj, enum.Enum):
        return obj.name
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__qualname__, {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(x) for x in obj)
    if isinstance(obj, (list, tuple)):
        return [plain(x) for x in obj]
    if isinstance(obj, np.ndarray):
        return plain(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def assert_plain_close(got, want, rtol=RTOL, path="$"):
    """``plain`` structures equal, floats within ``rtol``."""
    if isinstance(want, float) and isinstance(got, (int, float)):
        assert np.isclose(got, want, rtol=rtol, atol=1e-6), (path, got, want)
        return
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_plain_close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_plain_close(g, w, rtol, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def assert_same_ranked(got, want, key, rtol=RTOL, what=""):
    """Two ranked hit lists (``plain`` dicts with a "score"): equal length,
    scores rank by rank within ``rtol``, and, inside each run of reference
    scores within ``rtol`` of each other, the same hits as sets of
    ``key(hit)`` (ties may order either way); every hit's other fields are
    then compared through its key."""
    assert len(got) == len(want), (what, [key(h) for h in got], [key(h) for h in want])
    gs = np.array([h["score"] for h in got], np.float64)
    ws = np.array([h["score"] for h in want], np.float64)
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-6, err_msg=what)
    start = 0
    for pos in range(1, len(want) + 1):
        if pos == len(want) or not np.isclose(ws[pos], ws[pos - 1], rtol=rtol, atol=1e-6):
            assert {key(h) for h in got[start:pos]} == {key(h) for h in want[start:pos]}, (what, start, pos)
            start = pos
    by_key = {key(h): h for h in got}
    for h in want:
        assert_plain_close(by_key[key(h)], h, rtol, f"{what}:{key(h)}")


def assert_same_response(got, want):
    """Two ``ShardSearchResponse``s, of either package: vector keys equal
    and scores within RTOL, paragraph and document hits equal up to ties,
    graph paths and the prefilter equal."""
    g, w = plain(got)[1], plain(want)[1]
    assert [h[1]["key"] for h in g["vector"]] == [h[1]["key"] for h in w["vector"]]
    assert_plain_close(g["vector"], w["vector"])
    for leg, key in (("paragraph", "paragraph_id"), ("document", "key")):
        assert (g[leg] is None) == (w[leg] is None), leg
        if w[leg] is None:
            continue
        gl, wl = g[leg][1], w[leg][1]
        assert_same_ranked([h[1] for h in gl["hits"]], [h[1] for h in wl["hits"]], lambda h: h[key], what=leg)
        rest = {k: v for k, v in wl.items() if k not in ("hits", "ematches")}
        assert_plain_close({k: gl[k] for k in rest}, rest)
        if "ematches" in wl:
            assert sorted(gl["ematches"]) == sorted(wl["ematches"])
    assert_plain_close(g["graph"], w["graph"])
    assert g["prefilter"] == w["prefilter"]


def standalone_app(package, device="cpu"):
    """``package``'s ``StandaloneApp``: the JAX package's class as it is,
    the port's with ``device`` bound (the CPU unless a card test asks)."""
    import functools

    cls = importlib.import_module(f"{package}.standalone").StandaloneApp
    if package == "nucliadb_tpu":
        return cls
    return functools.partial(cls, device=device)


@contextlib.contextmanager
def serving(app, timeout=60):
    """Serve ``app`` (a ``StandaloneApp`` of either package) on an
    event-loop thread, as the front-end tests do, and yield an
    ``httpx.Client`` on its port; the loop stops on exit."""
    import asyncio
    import threading

    import httpx

    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.server.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(30), "server did not start"
    client = httpx.Client(base_url=f"http://127.0.0.1:{app.server.port}", timeout=timeout)
    try:
        yield client
    finally:
        client.close()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)


# the routing constants shrunk so a knowledge box of 2,000 paragraphs takes
# a full-size shard's routes (the int8 codes, a paragraph group of its own)
_SHRUNK = "device.EXACT_SCAN_THRESHOLD, device.HOST_SCAN_ELEMS, engine.GROUP_MIN_DOCS = 256, 0, 1000\n"


def rehearse_phase_http(chip_smoke, tmp_path, monkeypatch, device):
    """``chip_smoke.phase_find`` then ``phase_http`` at a small size on
    ``device``, with the routing constants shrunk in this process and in
    the CLI's interpreter; returns phase_http's counts."""
    import sys

    import torch

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as vector_device

    monkeypatch.setattr(vector_device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(vector_device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    command = chip_smoke.http_cli_command

    def cli_command(tmp, port, dev):
        argv = command(tmp, port, dev)
        assert argv[1:3] == ["-m", "nucliadb_tpu_torch.standalone.run"]
        prelude = (
            "import sys\n"
            "import nucliadb_tpu_torch.index.text_engine.engine as engine\n"
            "import nucliadb_tpu_torch.index.vector.device as device\n" + _SHRUNK
            + "from nucliadb_tpu_torch.standalone.run import main\n"
        )
        return [sys.executable, "-c", prelude + f"sys.argv = ['run', *{argv[3:]!r}]\nmain()\n"]

    monkeypatch.setattr(chip_smoke, "http_cli_command", cli_command)
    # dim 128: the top-2 scan's gate takes D a multiple of 128
    cfg = dict(chip_smoke.FIND_FULL, resources=40, paragraphs=50, dim=128, requests=12, filtered=4, secured=4,
               fusion=6, semantic=12, cpu=4)
    find = chip_smoke.phase_find(torch, str(tmp_path), cfg, device=device)
    http_cfg = dict(chip_smoke.HTTP_FULL, clients=4, timed=4, writes=3, deadline=120.0, bg_interval=1.0)
    return chip_smoke.phase_http(torch, str(tmp_path), find, http_cfg, device=device)


def rehearse_phase_cluster(chip_smoke, tmp_path, monkeypatch, device, **cfg):
    """``chip_smoke.phase_find`` then ``phase_cluster`` at a small size on
    ``device``, with the routing constants shrunk in this process and in
    every component process; returns phase_cluster's result."""
    import torch

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as vector_device

    monkeypatch.setattr(vector_device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(vector_device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    prelude = (
        "import nucliadb_tpu_torch.index.text_engine.engine as engine\n"
        "import nucliadb_tpu_torch.index.vector.device as device\n" + _SHRUNK
    )
    if device == "cpu":  # the plain version on the CPU: each replica counts what the kernel would
        prelude += (
            "from nucliadb_tpu_torch.ops import slot_scan\n"
            "_plain = slot_scan.int8_scan_slots_resident2\n"
            "def _counted(*a, **k):\n"
            "    slot_scan.LAUNCHES.add('top2')\n"
            "    return _plain(*a, **k)\n"
            "slot_scan.int8_scan_slots_resident2 = _counted\n"
        )
    monkeypatch.setattr(chip_smoke, "CLUSTER_CHILD", prelude + chip_smoke.CLUSTER_CHILD)
    find_cfg = dict(chip_smoke.FIND_FULL, resources=40, paragraphs=50, dim=128, requests=12, filtered=2, secured=2,
                    fusion=2, semantic=12, cpu=0, burst=4, timed=2)
    find = chip_smoke.phase_find(torch, str(tmp_path), find_cfg, device=device)
    cluster_cfg = dict(chip_smoke.CLUSTER_FULL, requests=12, threads=4, kill_after=4, boot_deadline=180.0,
                       deadline=60.0, **cfg)
    return chip_smoke.phase_cluster(torch, str(tmp_path), find, cluster_cfg, device=device)


def rehearse_phase_ops(chip_smoke, tmp_path, monkeypatch, device, **cfg):
    """``chip_smoke.phase_find`` then ``phase_ops`` at a small size on
    ``device``, with the routing constants shrunk in this process and the
    boot migrations applied as the HTTP phase's boot applies them; on the
    CPU the top-2 scan's plain calls count as its launches. Returns
    phase_ops's result."""
    import sys

    import torch

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as vector_device
    import nucliadb_tpu_torch.migrator.__main__ as migrator_cli
    from nucliadb_tpu_torch.ops import slot_scan

    monkeypatch.setattr(vector_device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(vector_device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    if device == "cpu":  # the plain version on the CPU: count what the kernel would
        plain = slot_scan.int8_scan_slots_resident2

        def counted(*a, **k):
            slot_scan.LAUNCHES.add("top2")
            return plain(*a, **k)

        monkeypatch.setattr(slot_scan, "int8_scan_slots_resident2", counted)
    find_cfg = dict(chip_smoke.FIND_FULL, resources=40, paragraphs=50, dim=128, requests=8, filtered=2, secured=2,
                    fusion=2, semantic=8, cpu=0, burst=4, timed=2)
    find = chip_smoke.phase_find(torch, str(tmp_path), find_cfg, device=device)
    monkeypatch.setattr(sys, "argv", ["migrator", "--data-dir", str(tmp_path), "--device", device])
    migrator_cli.main()
    ops_cfg = dict(chip_smoke.OPS_FULL, requests=8, **cfg)
    return chip_smoke.phase_ops(torch, str(tmp_path), find, ops_cfg, device=device)


# ---------------------------------------------------------------------------
# the BM25 program: inputs at the cases the kernel must get right
# ---------------------------------------------------------------------------

BM25_GROUP_CASES = {
    # a doc (local 3 of every group) in every row of every tier, every slot scheduled
    "hot_doc": dict(hot=True, n_q=6),
    # AND semantics: required 2 and 3, per-query masks
    "and_required": dict(with_counts=True, required=(1, 2, 3), n_q=6),
    # whole queries and tier rows of padding only
    "all_padding": dict(padding=True, with_counts=True, n_q=5),
    # a dense window reaching over the next group's docs (tf 0 there)
    "dense_overlap": dict(overlap=9, n_q=5),
    # one mask for the batch, the matched counts only
    "shared_count_only": dict(shared_mask=True, count_only=True, with_counts=True, n_q=7),
    # floors on the scores
    "min_score": dict(min_score=(-3.0e38, 1.5, 4.0), n_q=6),
    # equal tf, length and idf everywhere: a score is its hit count, and
    # thousands of columns tie at the k-th score, over rows the kernel cuts
    # into blocks (a query's row, 21,000 columns, in three)
    "ties_wide": dict(ties=True, sizes=(9000, 7000, 5000), n_q=2),
}


def bm25_group_case(name: str, seed: int = 0):
    """Inputs of the group program (numpy) for case ``name`` of
    ``BM25_GROUP_CASES``: three groups of 40, 24 and 30 docs, tiers of
    widths 4, 8 and 16, a dense block a group (8 columns past the group's
    docs, tf 0 there, or ``overlap`` more), and Q queries."""
    opts = BM25_GROUP_CASES[name]
    rng = np.random.default_rng(seed + 100 * list(BM25_GROUP_CASES).index(name))
    sizes, widths, rows_t = opts.get("sizes", (40, 24, 30)), (4, 8, 16), (5, 3, 2)
    ties = opts.get("ties", False)
    extra = 8 + opts.get("overlap", 0)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    L = int(sum(sizes)) + extra
    groups = []
    for n_g in sizes:
        dl_g = np.full(n_g + extra, 10.0, np.float32) if ties else rng.integers(1, 40, n_g + extra).astype(np.float32)
        tiers = []
        for w, t in zip(widths, rows_t):
            docs = np.full((t, w), -1, np.int32)
            for r in range(t):
                if opts.get("padding") and r == t - 1:
                    continue  # a row of padding only
                n = int(rng.integers(1, w + 1))
                pick = rng.choice(n_g, n, replace=False)
                if opts.get("hot"):
                    pick = np.unique(np.concatenate([pick[: n - 1], [3]]))
                docs[r, : len(pick)] = np.sort(pick)
            tfs = np.where(docs >= 0, 1 if ties else rng.integers(1, 6, docs.shape), 0).astype(np.float32)
            dls = np.where(docs >= 0, dl_g[np.maximum(docs, 0)], 1.0).astype(np.float32)
            tiers.append((docs, tfs, dls))
        dense = (rng.random((3, n_g + extra)) < 0.5 if ties else rng.integers(0, 4, (3, n_g + extra))).astype(np.uint8)
        dense[:, n_g:] = 0  # columns past the group's docs
        groups.append((tiers, dense, dl_g))
    caps = (3, 2, 2) * len(sizes) + (2,) * len(sizes)
    tier_counts = (len(widths),) * len(sizes)
    n_q = opts["n_q"]
    rows = np.zeros((n_q, sum(caps)), np.int32)
    col = 0
    for c, hi in zip(caps, [t for _ in sizes for t in rows_t] + [3] * len(sizes)):
        lo = 0 if opts.get("hot") else -1
        rows[:, col : col + c] = rng.integers(lo, hi, (n_q, c))
        col += c
    if opts.get("padding"):
        rows[0] = -1
    idfs = np.ones(rows.shape, np.float32) if ties else rng.uniform(0.2, 2.5, rows.shape).astype(np.float32)
    required = opts.get("required", (1,))
    floors = opts.get("min_score", (-3.0e38,))
    params = np.array(
        [[float(rng.uniform(8, 16)), required[q % len(required)], floors[q % len(floors)]] for q in range(n_q)],
        np.float32,
    )
    shared = opts.get("shared_mask", False)
    masks = rng.random(L if shared else (n_q, L)) > 0.1
    return dict(
        groups=groups, offsets=offsets, masks=masks, rows=rows, idfs=idfs, params=params, k=12,
        caps=caps, tier_counts=tier_counts, shared_mask=shared, count_only=opts.get("count_only", False),
        with_counts=opts.get("with_counts", False),
    )


BM25_ARENA_CASES = {
    "hot_doc_and": dict(hot=True, with_counts=True, required=(1, 2, 3)),
    "all_padding_or": dict(padding=True, min_score=(-3.0e38, 1.0)),
    "shared_count_only": dict(hot=True, with_counts=True, shared_mask=True, count_only=True),
}


def bm25_arena_case(name: str, seed: int = 0):
    """Inputs of the single-arena program (numpy) for case ``name`` of
    ``BM25_ARENA_CASES``: n_pad 96, three posting tiers of global doc ids,
    a base dense block and an overlay block of 16 columns at base 88
    (clamped to 80)."""
    opts = BM25_ARENA_CASES[name]
    rng = np.random.default_rng(seed + 200 + 100 * list(BM25_ARENA_CASES).index(name))
    n_pad, opad = 96, 16
    dlen = rng.integers(1, 40, n_pad).astype(np.float32)
    tiers = []
    for w, t in ((4, 4), (8, 3), (16, 2)):
        docs = np.full((t, w), -1, np.int32)
        for r in range(t - (1 if opts.get("padding") else 0)):
            n = int(rng.integers(1, w + 1))
            pick = rng.choice(n_pad - 8, n, replace=False)
            if opts.get("hot"):
                pick = np.unique(np.concatenate([pick[: n - 1], [7]]))
            docs[r, : len(pick)] = np.sort(pick)
        tfs = np.where(docs >= 0, rng.integers(1, 6, docs.shape), 0).astype(np.float32)
        dls = np.where(docs >= 0, dlen[np.maximum(docs, 0)], 1.0).astype(np.float32)
        tiers.append((docs, tfs, dls))
    dense = rng.integers(0, 3, (3, n_pad)).astype(np.uint8)
    odense = rng.integers(0, 4, (2, opad)).astype(np.uint8)
    caps = (3, 2, 2, 3, 2)
    n_q = 5
    lo = 0 if opts.get("hot") else -1
    rows = np.concatenate([
        rng.integers(lo, 4, (n_q, 3)), rng.integers(lo, 3, (n_q, 2)), rng.integers(lo, 2, (n_q, 2)),
        rng.integers(-1, 3, (n_q, 3)), rng.integers(-1, 2, (n_q, 2)),
    ], axis=1).astype(np.int32)
    if opts.get("padding"):
        rows[0] = -1
    idfs = rng.uniform(0.2, 2.5, rows.shape).astype(np.float32)
    required = opts.get("required", (1,))
    floors = opts.get("min_score", (-3.0e38,))
    params = np.array([[12.0, required[q % len(required)], floors[q % len(floors)]] for q in range(n_q)], np.float32)
    shared = opts.get("shared_mask", False)
    masks = rng.random(n_pad if shared else (n_q, n_pad)) > 0.1
    return dict(
        tiers=tiers, dense=dense, odense=odense, dlen=dlen, masks=masks, rows=rows, idfs=idfs, params=params,
        k=10, caps=caps, odense_base=88, shared_mask=shared, count_only=opts.get("count_only", False),
        with_counts=opts.get("with_counts", False),
    )


def bm25_torch_inputs(case: dict, device) -> dict:
    """``case`` with every array a tensor on ``device`` (offsets stay host
    ints, as the engine passes them)."""
    import torch

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = dict(case)
    if "groups" in case:
        out["groups"] = tuple(
            (tuple(tuple(t(a) for a in tier) for tier in tiers), t(dense), t(dl)) for tiers, dense, dl in case["groups"]
        )
        out["offsets"] = tuple(int(o) for o in case["offsets"])
    else:
        out["tiers"] = tuple(tuple(t(a) for a in tier) for tier in case["tiers"])
        for key in ("dense", "odense", "dlen"):
            out[key] = t(case[key])
    for key in ("masks", "rows", "idfs", "params"):
        out[key] = t(case[key])
    return out


def run_bm25_case(case: dict, device, kernel=None):
    """The port's program on ``case`` (tensors on ``device``): the group
    program through ``bm25.bm25_groups_batch`` or the arena through
    ``engine._bm25_search_batch``. ``kernel=False`` runs the plain version
    whatever the device (what the kernel is held against on the card)."""
    from nucliadb_tpu_torch.index.text_engine import engine as teng
    from nucliadb_tpu_torch.ops import bm25

    x = bm25_torch_inputs(case, device)
    flags = dict(count_only=x["count_only"], with_counts=x["with_counts"])
    if "groups" in x:
        args = (x["groups"], x["offsets"], x["masks"], x["rows"], x["idfs"], x["params"], x["k"], x["caps"],
                x["tier_counts"])
        if kernel is False:
            return bm25.plain_program(*args, flags["with_counts"], flags["count_only"])
        return bm25.bm25_groups_batch(*args, shared_mask=x["shared_mask"], **flags)
    args = (x["tiers"], x["dense"], x["odense"], x["dlen"], x["masks"], x["rows"], x["idfs"], x["params"], x["k"],
            x["caps"], x["odense_base"])
    if kernel is False:
        return teng._bm25_arena_plain(*args, flags["with_counts"], flags["count_only"])
    return teng._bm25_search_batch(*args, shared_mask=x["shared_mask"], **flags)


def bm25_case_rows(case: dict, device, kernel=True):
    """What the kernel writes for ``case`` before the cut: (final [Q, L],
    counts [Q, L] or None, matched [Q, L] or its [Q] counts), from one
    ``bm25.launch_program`` (``kernel``) or the plain version."""
    from nucliadb_tpu_torch.index.text_engine import engine as teng
    from nucliadb_tpu_torch.ops import bm25

    x = bm25_torch_inputs(case, device)
    wc, co = x["with_counts"], x["count_only"]
    if "groups" in x:
        if kernel:
            layout, overlay = bm25.group_layout(x["groups"], x["offsets"]), None
        else:
            out = bm25.plain_final(x["groups"], x["offsets"], x["masks"], x["rows"], x["idfs"], x["params"],
                                   x["caps"], x["tier_counts"], wc)
    else:
        if kernel:
            layout = bm25.arena_layout(x["tiers"], x["dense"], x["dlen"])
            overlay = bm25.overlay_layout(x["odense"], x["dlen"], len(x["tiers"]) + 1, x["odense_base"])
        else:
            out = teng._bm25_arena_final_plain(x["tiers"], x["dense"], x["odense"], x["dlen"], x["masks"], x["rows"],
                                               x["idfs"], x["params"], x["caps"], x["odense_base"], wc)
    if kernel:
        return bm25.launch_program(layout, x["caps"], x["masks"], x["rows"], x["idfs"], x["params"], wc, co,
                                   overlay=overlay)[:3]
    return (out[0], out[1], out[2].sum(dim=-1) if co else out[2])

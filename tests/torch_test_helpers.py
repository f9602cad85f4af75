"""Inputs and checks shared by the port's CPU and CUDA tests (numpy only,
so the CUDA tests run where jax is not installed)."""

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

"""The port's standalone server against the JAX package's, over HTTP.

- **Differential.** One HTTP script runs against a JAX ``StandaloneApp``
  and the port's ``StandaloneApp(device="cpu")``, each served on its own
  event-loop thread, with the same ``uuid4`` sequence in both packages (so
  kbids, rids and shard ids line up): a knowledge box with a vectorset,
  resources with embeddings, labels, relations and an access group, then
  ``/find`` (hybrid, semantic only, keyword only, a ``filter_expression``,
  security groups), ``/search``, ``/suggest``, ``/catalog``, a graph query
  and ``/ask``. Every JSON answer must equal the JAX package's with the
  wall-clock keys dropped (``WALL_CLOCK``): ids and order equal, scores
  within ``RTOL``. On both keyword routes (``NDBTPU_TEXT_HOST_TIER=0``
  forces the device program on both sides).
- **A data directory crosses packages.** An app of one package writes a
  knowledge box and closes; an app of the other boots over the same
  directory with no rollover (the shard ids and the segment formats are
  unchanged) and gives the same answers. Both ways.
- **Boot and warm-up.** ``StandaloneApp(device="cuda")`` raises on a
  machine without a card before it opens a file or binds a port; the
  warm-up runs on the CPU and its failure is reported, not swallowed; the
  CLI's ``--device`` reaches the node and the replicas' command line, and
  the replicas run the port's entry point.
"""

import itertools
import sys
import threading
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from tests.torch_test_helpers import assert_plain_close, serving, standalone_app

PACKAGES = ("nucliadb_tpu", "nucliadb_tpu_torch")
# keys whose values are time.time() of the run: they differ between runs
WALL_CLOCK = frozenset({"created", "modified", "timings"})
DIM = 16
WORDS = ("fox", "bear", "river", "forest", "market", "stock", "rally", "quick", "brown", "lazy", "night", "storm")


def _drop_wall_clock(obj):
    if isinstance(obj, dict):
        return {k: _drop_wall_clock(v) for k, v in obj.items() if k not in WALL_CLOCK}
    if isinstance(obj, list):
        return [_drop_wall_clock(x) for x in obj]
    return obj


def _corpus(n=12, seed=7):
    """Resource payloads (JSON) from a seed: two or three paragraphs of
    words each with its own embedding, a label of two labelsets, a relation
    and, on every fourth resource, the access group "staff"."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n):
        paras = [" ".join(rng.choice(WORDS, 6)) for _ in range(2 + r % 2)]
        embeddings, start = [], 0
        for text in paras:
            v = rng.standard_normal(DIM).astype(np.float32)
            embeddings.append({"start": start, "end": start + len(text), "vector": (v / np.linalg.norm(v)).tolist()})
            start += len(text) + 2
        payload = {
            "slug": f"doc-{r}",
            "title": f"doc {r} {paras[0].split()[0]}",
            "texts": {"body": {"body": "\n\n".join(paras)}},
            "usermetadata": {"classifications": [
                {"labelset": "topic", "label": ("animals", "finance", "weather")[r % 3]},
                {"labelset": "lang", "label": ("en", "es")[r % 2]},
            ]},
            "usergenerated_relations": [{
                "relation": "ENTITY", "label": "mentions",
                "from": {"value": f"doc{r}", "group": "doc"},
                "to": {"value": paras[0].split()[1], "group": "word"},
            }],
            "embeddings": {"m": {"body": embeddings}},
        }
        if r % 4 == 0:
            payload["security"] = {"access_groups": ["staff"]}
        out.append(payload)
    return out


def _script(client, corpus):
    """The differential HTTP script; returns [(what, status, JSON)]."""
    out = []

    def call(what, method, path, **kw):
        resp = client.request(method, path, **kw)
        out.append((what, resp.status_code, resp.json()))
        assert resp.status_code < 300, (what, resp.text)
        return resp.json()

    kbid = call("create kb", "POST", "/api/v1/kbs", json={"slug": "diff", "vectorsets": {"m": {"dimension": DIM}}})["uuid"]
    for payload in corpus:
        call("create resource", "POST", f"/api/v1/kb/{kbid}/resources", json=payload)
    q = corpus[5]["embeddings"]["m"]["body"][0]["vector"]
    kb = f"/api/v1/kb/{kbid}"
    call("find hybrid", "POST", f"{kb}/find", json={"query": "quick fox river", "vector": q, "top_k": 8})
    call("find semantic", "POST", f"{kb}/find", json={"query": "", "vector": q, "features": ["semantic"], "top_k": 8})
    call("find keyword", "POST", f"{kb}/find", json={"query": "market stock", "features": ["keyword"], "top_k": 8})
    call("find filter_expression", "POST", f"{kb}/find", json={
        "query": "fox bear", "vector": q, "top_k": 8,
        "filter_expression": {"field": {"prop": "label", "labelset": "topic", "label": "animals"}},
    })
    call("find security", "POST", f"{kb}/find", json={"query": "storm night", "vector": q, "top_k": 8,
                                                      "security": {"groups": ["outsiders"]}})
    call("find security staff", "POST", f"{kb}/find", json={"query": "storm night", "vector": q, "top_k": 8,
                                                            "security": {"groups": ["staff"]}})
    call("search", "POST", f"{kb}/search", json={"query": "lazy brown", "features": ["fulltext", "keyword"],
                                                 "faceted": ["/l/topic"]})
    call("suggest", "GET", f"{kb}/suggest", params={"query": "riv"})
    call("catalog", "POST", f"{kb}/catalog", json={"faceted": ["/l/topic", "/l/lang"]})
    call("graph", "POST", f"{kb}/graph", json={"source_value": "doc3"})
    call("ask", "POST", f"{kb}/ask", json={"query": "quick fox", "vector": q},
         headers={"x-synchronous": "true"})
    return out


def _run_script(pkg, data_dir, monkeypatch):
    # every uuid4 the package draws (kbids, shard ids, rids: the routes
    # import uuid in their bodies too) from one sequence, the same for both
    # packages; other callers (a library's first import) keep the real one
    counter, real = itertools.count(1), uuid.uuid4

    def uuid4():
        caller = sys._getframe(1).f_globals.get("__name__", "")
        return uuid.UUID(int=next(counter)) if caller.split(".")[0] == pkg else real()

    monkeypatch.setattr(uuid, "uuid4", uuid4)
    app = standalone_app(pkg)(data_dir=str(data_dir), host="127.0.0.1", port=0)
    try:
        with serving(app) as client:
            return _script(client, _corpus())
    finally:
        app.stop_background()


@pytest.mark.parametrize("route", ["default", "device"])
def test_http_answers_equal_the_jax_package(route, tmp_path, monkeypatch):
    if route == "device":
        monkeypatch.setenv("NDBTPU_TEXT_HOST_TIER", "0")
    want, got = (_run_script(pkg, tmp_path / pkg, monkeypatch) for pkg in PACKAGES)
    assert [w[:2] for w in want] == [g[:2] for g in got]
    for (what, _, w), (_, _, g) in zip(want, got):
        assert_plain_close(_drop_wall_clock(g), _drop_wall_clock(w), path=what)
    by_what = {what: body for what, _, body in got}
    # the script exercises what it says: hits on every leg, filters applied
    assert by_what["find hybrid"]["resources"] and by_what["find semantic"]["resources"]
    assert by_what["find keyword"]["resources"] and by_what["graph"]["paths"]
    rids = [body["uuid"] for what, _, body in got if what == "create resource"]
    staff_only = set(rids[::4])  # the resources in the access group "staff"
    assert not staff_only & set(by_what["find security"]["resources"])
    assert staff_only & set(by_what["find security staff"]["resources"])


# ---------------------------------------------------------------------------
# a data directory written by one package, booted by the other
# ---------------------------------------------------------------------------

_CROSS_REQUESTS = (
    {"query": "quick fox river", "top_k": 8},
    {"query": "market stock", "features": ["keyword"], "top_k": 8},
    {"query": "", "features": ["semantic"], "top_k": 8},
)


def _answers(client, kbid, q):
    return [
        _drop_wall_clock(client.post(f"/api/v1/kb/{kbid}/find", json=dict(req, vector=q)).json())
        for req in _CROSS_REQUESTS
    ]


def _segment_formats(app, shard_ids):
    return sorted(
        (idx.kind, seg.index_metadata.get("format_version"))
        for sid in shard_ids
        for idx in app.node.metadata.get_indexes(sid)
        for seg in app.node.metadata.ready_segments(idx.id)
    )


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]])
def test_data_directory_crosses_packages(writer, reader, tmp_path):
    corpus = _corpus(8, seed=3)
    q = corpus[2]["embeddings"]["m"]["body"][0]["vector"]
    first = standalone_app(writer)(data_dir=str(tmp_path), host="127.0.0.1", port=0)
    with serving(first) as client:
        kbid = client.post("/api/v1/kbs", json={"slug": "cross", "vectorsets": {"m": {"dimension": DIM}}}).json()["uuid"]
        for payload in corpus:
            assert client.post(f"/api/v1/kb/{kbid}/resources", json=payload).status_code == 201
        first.node.tick_background()  # merges: segments of the writer's merge policy
        first._sync(force=True)
        want = _answers(client, kbid, q)
    shards = first.kbs.get_shards(kbid).shards
    formats = _segment_formats(first, shards)
    first.stop_background()
    del first

    second = standalone_app(reader)(data_dir=str(tmp_path), host="127.0.0.1", port=0)
    try:
        # no rollover at boot: the same shards, segments of the same formats
        assert second.kbs.get_shards(kbid).shards == shards
        assert _segment_formats(second, shards) == formats
        assert {kind for kind, _ in formats} >= {"vector", "paragraph", "text"}
        with serving(second) as client:
            got = _answers(client, kbid, q)
    finally:
        second.stop_background()
    assert all(w["resources"] for w in want)
    assert_plain_close(got, want)


def test_segment_format_versions_match():
    """The versions the boot migrations compare: equal in both packages, so
    neither package's boot rolls the other's segments over."""
    from nucliadb_tpu.index.text_engine.builder import TEXT_FORMAT_VERSION as jax_text
    from nucliadb_tpu.index.vector.segment import FORMAT_VERSION as jax_vector
    from nucliadb_tpu.migrator import latest_version as jax_latest
    from nucliadb_tpu_torch.index.text_engine.builder import TEXT_FORMAT_VERSION
    from nucliadb_tpu_torch.index.vector.segment import FORMAT_VERSION
    from nucliadb_tpu_torch.migrator import latest_version

    import nucliadb_tpu.migrator.migrations  # noqa: F401 — registers them
    import nucliadb_tpu_torch.migrator.migrations  # noqa: F401

    assert (FORMAT_VERSION, TEXT_FORMAT_VERSION, latest_version()) == (jax_vector, jax_text, jax_latest())


# ---------------------------------------------------------------------------
# boot and warm-up
# ---------------------------------------------------------------------------


def test_cuda_app_without_a_card_raises_before_it_opens_anything(tmp_path, monkeypatch):
    import torch

    from nucliadb_tpu_torch.http import server as http_server
    from nucliadb_tpu_torch.standalone import StandaloneApp

    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda app is valid here")
    bound = []
    monkeypatch.setattr(http_server.HTTPServer, "start", lambda self: bound.append(self))
    data_dir = tmp_path / "data"
    with pytest.raises(RuntimeError, match="cuda"):
        StandaloneApp(data_dir=str(data_dir), host="127.0.0.1", port=0)
    assert not data_dir.exists() and not bound


def test_warmup_runs_on_the_cpu(monkeypatch):
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.utils import warmup
    from nucliadb_tpu_torch.utils.warmup import warmup_kernels

    monkeypatch.setattr(warmup, "_done", set())  # as in a fresh process: an app booted earlier warmed the CPU
    before = bm25.DISPATCHES.get("single", 0)
    seconds = warmup_kernels("cpu")
    assert seconds > 0 and bm25.DISPATCHES.get("single", 0) == before + 1


def test_warmup_failure_is_reported_not_swallowed(tmp_path, monkeypatch):
    from nucliadb_tpu_torch.utils import warmup

    def broken(device):
        raise RuntimeError("nvcc failed for int8_slot_scan.cu")

    reported = []
    monkeypatch.setattr(warmup, "warmup_kernels", broken)
    monkeypatch.setattr(threading, "excepthook", lambda args: reported.append(args.exc_value))
    app = standalone_app("nucliadb_tpu_torch")(data_dir=str(tmp_path), host="127.0.0.1", port=0)
    try:
        app.start_background(3600.0)
        app._warmup_thread.join(30)
    finally:
        app.stop_background()
    assert [str(e) for e in reported] == ["nvcc failed for int8_slot_scan.cu"]
    assert app.warmup_seconds is None


def test_warmup_thread_records_its_seconds(tmp_path, monkeypatch):
    from nucliadb_tpu_torch.utils import warmup

    monkeypatch.setattr(warmup, "_done", set())  # as in a fresh process
    app = standalone_app("nucliadb_tpu_torch")(data_dir=str(tmp_path), host="127.0.0.1", port=0)
    try:
        app.start_background(3600.0)
        app._warmup_thread.join(60)
    finally:
        app.stop_background()
    assert app.warmup_seconds is not None and app.warmup_seconds > 0
    assert app.device.type == "cpu" and app.node.device.type == "cpu"


def test_cli_device_reaches_the_node_and_the_replicas(tmp_path, monkeypatch):
    from nucliadb_tpu_torch.standalone import run, workers

    seen = {}

    class Stop(Exception):
        pass

    def fake_app(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(run, "StandaloneApp", fake_app)
    monkeypatch.setattr(sys, "argv", ["run", "--data-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(Stop):
        run.main()
    assert seen["device"] == "cpu"
    monkeypatch.setattr(sys, "argv", ["run", "--data-dir", str(tmp_path)])
    with pytest.raises(Stop):
        run.main()
    assert seen["device"] == "cuda"  # the card unless the caller asks for the CPU

    args = SimpleNamespace(auth_policy="api_key", api_key=["t=READER"], local_predict=True, device="cpu")
    extra = run.replica_args(args)
    assert extra[extra.index("--device") + 1] == "cpu"
    assert extra[extra.index("--api-key") + 1] == "t=READER" and "--local-predict" in extra

    spawned = []
    monkeypatch.setattr("subprocess.Popen", lambda cmd, env=None: spawned.append(cmd))
    workers.spawn_replicas(2, data_dir=str(tmp_path), host="127.0.0.1", port=1, extra_args=extra)
    assert len(spawned) == 2
    for cmd in spawned:
        assert cmd[1:3] == ["-m", "nucliadb_tpu_torch.standalone.run"]
        assert cmd[cmd.index("--device") + 1] == "cpu"

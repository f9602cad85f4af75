"""The scenarios of ``tests/test_standalone_http.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules: the second half of its
tests (``test_torch_standalone_http.py`` holds the first).
"""

import asyncio
import threading
import json

import httpx
import numpy as np
import pytest

from tests.torch_test_helpers import standalone_app

StandaloneApp = standalone_app("nucliadb_tpu_torch")


DIM = 16


def embed(text):
    r = np.random.default_rng(abs(hash(text)) % (2**31))
    v = r.standard_normal(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("standalone")), host="127.0.0.1", port=0
    )
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.server.start())
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    started.wait(10)
    base = f"http://127.0.0.1:{app.server.port}"
    client = httpx.Client(base_url=base, timeout=60)
    yield client, app
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_reference_model_aliases(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "alias-kb"}).json()["uuid"]
    for i in range(3):
        client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={"title": f"a{i}", "texts": {"t": {"body": f"alias token doc {i}"}}},
        )
    # reference min_score object + page_size/page_number spellings
    out = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "alias token", "min_score": {"bm25": 0.0, "semantic": 0.4},
              "page_size": 2, "page_number": 0},
    )
    assert out.status_code == 200, out.text
    assert len(out.json()["best_matches"]) <= 2
    page2 = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "alias token", "page_size": 2, "page_number": 1},
    ).json()
    assert page2["best_matches"] != out.json()["best_matches"]

    # ask with a CustomPrompt object + features + max_tokens accepted
    ask = client.post(
        f"/api/v1/kb/{kbid}/ask",
        json={"query": "alias token", "prompt": {"system": "Be terse.", "user": "Answer:"},
              "features": ["keyword"], "max_tokens": 50,
              "answer_json_schema": {"type": "object"}},
        headers={"x-synchronous": "true"},
    )
    assert ask.status_code == 200, ask.text
    assert ask.json()["status"] in ("success", "no_generative_model")


def test_legacy_filters_and_alias_labels(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "lfilt-kb"}).json()["uuid"]
    r_sport = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "s", "texts": {"t": {"body": "legacy filter body"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "sports"}]}},
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "n", "texts": {"t": {"body": "legacy filter body"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "news"}]}},
    )
    # legacy filters list with the reference's alias spelling
    out = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "legacy filter",
              "filters": ["/classification.labels/topic/sports"]},
    ).json()
    assert list(out["resources"]) == [r_sport]
    # same alias inside a filter_expression literal
    out2 = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "legacy filter",
              "filter_expression": {"literal": "/classification.labels/topic/sports"}},
    ).json()
    assert list(out2["resources"]) == [r_sport]
    # system spelling still works
    out3 = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "legacy filter", "filters": ["/l/topic/sports"]},
    ).json()
    assert list(out3["resources"]) == [r_sport]


def test_suggest_with_filters(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "sugg-filt-kb"}).json()["uuid"]
    r_sport = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "s", "texts": {"t": {"body": "suggestable body sports"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "sports"}]}},
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "n", "texts": {"t": {"body": "suggestable body news"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "news"}]}},
    )
    out = client.post(
        f"/api/v1/kb/{kbid}/suggest",
        json={"query": "suggest", "filters": ["/classification.labels/topic/sports"]},
    ).json()
    assert out["paragraphs"] and all(p["rid"] == r_sport for p in out["paragraphs"])
    unfiltered = client.post(
        f"/api/v1/kb/{kbid}/suggest", json={"query": "suggest"}
    ).json()
    assert len({p["rid"] for p in unfiltered["paragraphs"]}) == 2


def test_standalone_introspection_and_temp_tokens(tmp_path_factory):
    import asyncio
    import threading

    from nucliadb_tpu_torch.standalone.auth import AuthSettings

    auth = AuthSettings(policy="upstream_naive")
    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("token-srv")), port=0, auth=auth
    )
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.server.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    started.wait(10)
    client = httpx.Client(base_url=f"http://127.0.0.1:{app.server.port}", timeout=30)
    ident = {"x-nucliadb-roles": "READER;WRITER", "x-nucliadb-user": "alice"}

    # versions + config-check report identity
    assert "nucliadb_tpu" in client.get("/api/v1/versions", headers=ident).json()
    check = client.get("/api/v1/config-check", headers=ident).json()
    assert check["user"]["username"] == "alice"
    assert "READER" in check["user"]["roles"]

    # temp token: issued with the caller's roles, then authenticates a
    # header-less request via the eph-token query param
    kbid_resp = client.post(
        "/api/v1/kbs", json={"slug": "tok-kb"},
        headers={"x-nucliadb-roles": "MANAGER", "x-nucliadb-user": "admin"},
    )
    assert kbid_resp.status_code == 201
    kbid = kbid_resp.json()["uuid"]
    token = client.get("/api/v1/temp-access-token", headers=ident).json()["token"]
    assert client.get(f"/api/v1/kb/{kbid}").status_code == 401  # no headers
    got = client.get(f"/api/v1/kb/{kbid}", params={"eph-token": token})
    assert got.status_code == 200, got.text
    # tampered token is rejected
    bad = token[:-3] + ("AAA" if not token.endswith("AAA") else "BBB")
    assert client.get(
        f"/api/v1/kb/{kbid}", params={"eph-token": bad}
    ).status_code == 401
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_catalog_title_matching_and_field_type_filters(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "cat-title-kb"}).json()["uuid"]
    r_title = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "quarterly budget report",
              "texts": {"t": {"body": "nothing relevant here"}}},
    ).json()["uuid"]
    r_body = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "unrelated name",
              "texts": {"t": {"body": "budget discussion in the body"}}},
    ).json()["uuid"]

    # catalog query matches TITLES only (parity: catalog/pg.py title ILIKE)
    cat = client.post(f"/api/v1/kb/{kbid}/catalog", json={"query": "budget"}).json()
    ids = [r["id"] for r in cat["resources"]]
    assert r_title in ids and r_body not in ids

    # find with the reference's /field alias restricts to field types
    out = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "budget", "filters": ["/field/t"]},
    ).json()
    assert list(out["resources"]) == [r_body]
    out2 = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "budget", "filters": ["/field/a"]},
    ).json()
    assert list(out2["resources"]) == [r_title]


def test_graph_boolean_path_expressions(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "gexpr-kb"}).json()["uuid"]
    rels = [
        ("alice", "works_at", "acme"),
        ("bob", "works_at", "acme"),
        ("alice", "knows", "bob"),
        ("carol", "works_at", "globex"),
    ]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "graph", "usergenerated_relations": [
            {"relation": "ENTITY", "label": lbl,
             "from": {"value": s, "group": "people"},
             "to": {"value": t, "group": "org" if lbl == "works_at" else "people"}}
            for s, lbl, t in rels
        ]},
    )

    def paths(query, top_k=50):
        out = client.post(
            f"/api/v1/kb/{kbid}/graph", json={"query": query, "top_k": top_k}
        )
        assert out.status_code == 200, out.text
        return {(p["source"], p["label"], p["target"]) for p in out.json()["paths"]}

    # leaf: everyone at acme
    assert paths({"prop": "path", "destination": {"value": "acme"},
                  "relation": {"label": "works_at"}}) == {
        ("alice", "works_at", "acme"), ("bob", "works_at", "acme")}
    # and: acme workers, excluding bob as source
    assert paths({"and": [
        {"prop": "path", "destination": {"value": "acme"}},
        {"not": {"prop": "source_node", "value": "bob"}},
    ]}) == {("alice", "works_at", "acme")}
    # or over relations
    assert paths({"or": [
        {"prop": "relation", "label": "knows"},
        {"prop": "node", "value": "carol"},
    ]}) == {("alice", "knows", "bob"), ("carol", "works_at", "globex")}
    # fuzzy node leaf (distance 1, like nidx FUZZY_DISTANCE)
    assert paths({"prop": "node", "value": "alics", "match": "fuzzy"}) == {
        ("alice", "works_at", "acme"), ("alice", "knows", "bob")}
    # invalid node -> 422
    bad = client.post(f"/api/v1/kb/{kbid}/graph", json={"query": {"prop": "wat"}})
    assert bad.status_code == 422


def test_graph_nodes_relations_expressions(server):
    """/graph/nodes takes GraphNodesQuery (node/generated leaves only,
    evaluated at source AND destination positions — reference
    nucliadb_models/graph/requests.py GraphNodesQuery +
    nidx_relation/src/reader.rs nodes_graph_search); /graph/relations
    accepts the full path query (reader.rs relations_graph_search)."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "gexpr2-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "g", "usergenerated_relations": [
            {"relation": "ENTITY", "label": "works_at",
             "from": {"value": "alice", "group": "people"},
             "to": {"value": "acme", "group": "org"}},
            {"relation": "ENTITY", "label": "knows",
             "from": {"value": "alice", "group": "people"},
             "to": {"value": "bob", "group": "people"}},
        ]},
    )
    # node query by group, matched at either path position
    nodes = client.post(
        f"/api/v1/kb/{kbid}/graph/nodes",
        json={"query": {"prop": "node", "group": "people"}},
    ).json()["nodes"]
    assert {n["value"] for n in nodes} == {"alice", "bob"}
    assert all(n["score"] is not None for n in nodes)
    # nodes are unique even when they appear in many paths
    nodes = client.post(
        f"/api/v1/kb/{kbid}/graph/nodes",
        json={"query": {"prop": "node", "value": "alice"}},
    ).json()["nodes"]
    assert [n["value"] for n in nodes] == ["alice"]
    # relation leaves are not valid node queries (GraphNodesQuery)
    bad = client.post(
        f"/api/v1/kb/{kbid}/graph/nodes",
        json={"query": {"prop": "relation", "label": "works_at"}},
    )
    assert bad.status_code == 422
    rels = client.post(
        f"/api/v1/kb/{kbid}/graph/relations",
        json={"query": {"prop": "source_node", "value": "alice"}},
    ).json()["relations"]
    assert {r["label"] for r in rels} == {"works_at", "knows"}
    # distinct relations collapse duplicate (type, label) pairs
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "g2", "usergenerated_relations": [
            {"relation": "ENTITY", "label": "works_at",
             "from": {"value": "carol", "group": "people"},
             "to": {"value": "initech", "group": "org"}},
        ]},
    )
    rels = client.post(
        f"/api/v1/kb/{kbid}/graph/relations",
        json={"query": {"prop": "relation", "label": "works_at"}},
    ).json()["relations"]
    assert [r["label"] for r in rels] == ["works_at"]


def test_usermetadata_relations_wire_shape(server):
    """User relations arrive under usermetadata.relations on the reference
    wire (nucliadb_models/metadata.py:135-137); they index into the graph
    and round-trip on GET alongside the legacy top-level field."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "umrel-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "um",
            "usermetadata": {"relations": [
                {"relation": "ENTITY", "label": "works_at",
                 "from": {"value": "dave", "type": "entity", "group": "people"},
                 "to": {"value": "hooli", "type": "entity", "group": "org"}},
            ]},
        },
    ).json()["uuid"]
    out = client.post(
        f"/api/v1/kb/{kbid}/graph",
        json={"query": {"prop": "path", "destination": {"value": "hooli"}}},
    ).json()
    assert {(p["source"], p["label"], p["target"]) for p in out["paths"]} == {
        ("dave", "works_at", "hooli")
    }
    got = client.get(f"/api/v1/kb/{kbid}/resource/{rid}?show=basic").json()
    assert [r["label"] for r in got["usermetadata"]["relations"]] == ["works_at"]
    # entity label facet derives from usermetadata relations too
    catalog = client.post(
        f"/api/v1/kb/{kbid}/catalog",
        json={"filters": ["/e/people/dave"]},
    ).json()
    assert rid in {r["id"] for r in catalog["resources"]}


def test_graph_fuzzy_words_and_generated(server):
    """Word-level fuzzy node matching (Term::FuzzyWord — every query word
    fuzzy-matches some word of the node value) and the generated-by
    predicate over /g facets (requests.py Generated ->
    query_parser/parsers/graph.py:319-331)."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "gfw-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "g",
            "usergenerated_relations": [
                {"relation": "ENTITY", "label": "rules",
                 "from": {"value": "Princess Anastasia Romanov", "group": "people"},
                 "to": {"value": "Russia", "group": "place"}},
            ],
            "computed_relations": [
                {"relation": "ENTITY", "label": "born_in",
                 "from": {"value": "Anastasia", "group": "people"},
                 "to": {"value": "Peterhof", "group": "place"}},
                {"relation": "ENTITY", "label": "synonym",
                 "data_augmentation_task_id": "labeler-1",
                 "from": {"value": "Anastasia", "group": "people"},
                 "to": {"value": "Nastya", "group": "people"}},
            ],
        },
    )

    def paths(query):
        out = client.post(f"/api/v1/kb/{kbid}/graph", json={"query": query})
        assert out.status_code == 200, out.text
        return {(p["source"], p["label"], p["target"]) for p in out.json()["paths"]}

    # whole-value fuzzy does NOT match a multi-word value...
    assert paths({"prop": "node", "value": "anastascia", "match": "fuzzy"}) == {
        ("Anastasia", "born_in", "Peterhof"), ("Anastasia", "synonym", "Nastya")}
    # ...fuzzy_words does (each query word matches some value word, d<=1)
    assert ("Princess Anastasia Romanov", "rules", "Russia") in paths(
        {"prop": "node", "value": "princess anastascia", "match": "fuzzy_words"})
    # generated-by: user relations carry /g/u
    assert paths({"prop": "generated", "by": "user"}) == {
        ("Princess Anastasia Romanov", "rules", "Russia")}
    # processor = no /g facet at all
    assert paths({"prop": "generated", "by": "processor"}) == {
        ("Anastasia", "born_in", "Peterhof")}
    # data-augmentation, optionally narrowed by task prefix
    assert paths({"prop": "generated", "by": "data-augmentation"}) == {
        ("Anastasia", "synonym", "Nastya")}
    assert paths({"prop": "generated", "by": "data-augmentation",
                  "da_task": "labeler"}) == {("Anastasia", "synonym", "Nastya")}
    assert paths({"prop": "generated", "by": "data-augmentation",
                  "da_task": "other"}) == set()
    # combinator: DA-generated AND touching anastasia
    assert paths({"and": [
        {"prop": "generated", "by": "data-augmentation"},
        {"prop": "node", "value": "anastasia"},
    ]}) == {("Anastasia", "synonym", "Nastya")}


def test_graph_resource_constraints(server):
    client, app = server
    kbid = client.post(
        "/api/v1/kbs", json={"slug": "gsec-kb", "hidden_resources_enabled": True}
    ).json()["uuid"]

    def mk(title, rels, labels=None, groups=None, hidden=False):
        body = {"title": title, "hidden": hidden, "usergenerated_relations": [
            {"relation": "ENTITY", "label": lbl,
             "from": {"value": s, "group": "g"}, "to": {"value": t, "group": "g"}}
            for s, lbl, t in rels]}
        if labels:
            body["usermetadata"] = {"classifications": [
                {"labelset": s, "label": l} for s, l in labels]}
        if groups:
            body["security"] = {"access_groups": groups}
        return client.post(f"/api/v1/kb/{kbid}/resources", json=body).json()["uuid"]

    mk("open", [("a", "r1", "b")], labels=[("topic", "x")])
    mk("sec", [("c", "r1", "d")], groups=["team1"])
    mk("hid", [("e", "r1", "f")], hidden=True)

    def paths(**extra):
        out = client.post(
            f"/api/v1/kb/{kbid}/graph",
            json={"query": {"prop": "relation", "label": "r1"}, **extra},
        ).json()["paths"]
        return {p["source"] for p in out}

    # hidden excluded by default; shown on demand
    assert paths() == {"a", "c"}
    assert paths(show_hidden=True) == {"a", "c", "e"}
    # security view without team1 loses the restricted resource
    assert paths(security={"groups": ["other"]}) == {"a"}
    assert paths(security={"groups": ["team1"]}) == {"a", "c"}
    # label filter keeps only the labelled resource's edges
    assert paths(filter_expression={"field": {"literal": "/l/topic/x"}}) == {"a"}


def test_find_show_options(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "show-find-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "shown doc", "icon": "application/pdf",
              "texts": {"t": {"body": "showable body text"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "z"}]},
              "usergenerated_relations": [
                  {"relation": "ENTITY", "label": "l",
                   "from": {"value": "x"}, "to": {"value": "y"}}]},
    ).json()["uuid"]

    base = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "showable"}).json()
    assert base["resources"][rid].get("data") is None

    full = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "showable", "show": ["basic", "values", "relations"]},
    ).json()
    data = full["resources"][rid]["data"]
    assert data["icon"] == "application/pdf"
    assert data["labels"] == ["/l/topic/z"]
    assert data["texts"]["t"]["body"] == "showable body text"
    assert data["usergenerated_relations"][0]["label"] == "l"
    assert data["created"] is not None


def test_resource_extra_metadata(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "extra-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "x", "extra": {"metadata": {"pipeline": 7, "tags": ["a"]}}},
    ).json()["uuid"]
    base = f"/api/v1/kb/{kbid}/resource/{rid}"
    assert "extra" not in client.get(base, params={"show": "basic"}).json()
    got = client.get(base, params={"show": "basic,extra"}).json()
    assert got["extra"] == {"metadata": {"pipeline": 7, "tags": ["a"]}}
    # PATCH preserves/replaces it
    client.patch(base, json={"extra": {"metadata": {"pipeline": 8}}})
    got = client.get(base, params={"show": "values"}).json()
    assert got["extra"]["metadata"]["pipeline"] == 8


def test_find_get_query_params(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "getparams-kb"}).json()["uuid"]
    r1 = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "s", "texts": {"t": {"body": "getparam body sports"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "sports"}]}},
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "n", "texts": {"t": {"body": "getparam body news"}},
              "usermetadata": {"classifications": [{"labelset": "topic", "label": "news"}]}},
    )
    out = client.get(
        f"/api/v1/kb/{kbid}/find",
        params=[("query", "getparam body"), ("features", "keyword"),
                ("filters", "/l/topic/sports"), ("top_k", "5"),
                ("highlight", "true")],
    )
    assert out.status_code == 200, out.text
    assert list(out.json()["resources"]) == [r1]
    # pagination params
    page = client.get(
        f"/api/v1/kb/{kbid}/find",
        params={"query": "getparam body", "top_k": 1, "offset": 1},
    ).json()
    assert len(page["best_matches"]) == 1


def test_find_debug_timings(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "dbg-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "d", "texts": {"t": {"body": "debug timing body"}}},
    )
    out = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "debug timing", "debug": True}
    ).json()
    assert out["timings"] is not None
    assert {"retrieval", "fusion", "hydration"} <= set(out["timings"])
    plain = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "debug timing"}
    ).json()
    assert plain["timings"] is None


def test_catalog_get_variant(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "catget-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "list me",
              "usermetadata": {"classifications": [{"labelset": "t", "label": "x"}]}},
    )
    out = client.get(
        f"/api/v1/kb/{kbid}/catalog",
        params={"page_size": 10, "faceted": "/l/t"},
    )
    assert out.status_code == 200, out.text
    body = out.json()
    assert body["total"] == 1 and body["resources"][0]["title"] == "list me"
    assert body["facets"]


def test_resource_ask_ndjson_stream(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "rask-stream-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "s", "texts": {"t": {"body": "streamable resource answer"}}},
    ).json()["uuid"]
    out = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/ask",
        params={"stream": "ndjson"},
        json={"query": "streamable"},
    )
    assert out.status_code == 200, out.text
    items = [json.loads(l) for l in out.text.splitlines() if l]
    kinds = [i["item"]["type"] for i in items]
    assert kinds[0] == "retrieval" and kinds[-1] == "status"


def test_field_crud_routes(server):
    """Per-field CRUD (parity: writer/api/v1/field.py): PUT a single
    text/link/key_value field 201, GET its value, DELETE {field_type}/
    {field_id} 204 — with the change visible in search immediately."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "fieldcrud-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "f", "texts": {"t1": {"body": "original body"}}},
    ).json()["uuid"]

    out = client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/text/t2",
        json={"body": "pluto is a dwarf planet"},
    )
    assert out.status_code == 201, out.text
    got = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/text/t2").json()
    assert got["body"] == "pluto is a dwarf planet"
    # the new field is searchable
    app._sync(force=True)
    found = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "dwarf planet", "top_k": 5}
    ).json()
    assert rid in found["resources"]

    out = client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/link/l1",
        json={"uri": "https://example.com"},
    )
    assert out.status_code == 201, out.text
    assert client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/link/l1"
    ).json()["uri"] == "https://example.com"

    out = client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/key_value/meta",
        json={"answer": 42},
    )
    assert out.status_code == 201, out.text
    assert client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/key_value/meta"
    ).json() == {"answer": 42}

    # delete a field; it disappears from the payload and from search
    out = client.delete(f"/api/v1/kb/{kbid}/resource/{rid}/text/t2")
    assert out.status_code == 204
    assert client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/text/t2"
    ).status_code == 404
    app._sync(force=True)
    found = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "dwarf planet", "top_k": 5}
    ).json()
    assert rid not in found["resources"]
    # slug twin works too
    client.patch(f"/api/v1/kb/{kbid}/resource/{rid}", json={"slug": "fslug"})
    assert client.get(
        f"/api/v1/kb/{kbid}/slug/fslug/text/t1"
    ).json()["body"] == "original body"
    assert client.delete(
        f"/api/v1/kb/{kbid}/resource/{rid}/text/missing"
    ).status_code == 404


def test_learning_strategies_and_nua_schema(server):
    """extract/split strategies CRUD + /nua/schema (parity:
    writer/api/v1/learning_config.py:66-140)."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "strat-kb"}).json()["uuid"]
    for kind in ("extract", "split"):
        sid = client.post(
            f"/api/v1/kb/{kbid}/{kind}_strategies",
            json={"name": f"{kind}-s1", "vllm_config": {"x": 1}},
        ).json()
        listing = client.get(f"/api/v1/kb/{kbid}/{kind}_strategies").json()
        assert listing[sid]["name"] == f"{kind}-s1"
        one = client.get(
            f"/api/v1/kb/{kbid}/{kind}_strategies/strategy/{sid}"
        ).json()
        assert one["vllm_config"] == {"x": 1}
        assert client.delete(
            f"/api/v1/kb/{kbid}/{kind}_strategies/strategy/{sid}"
        ).status_code == 204
        assert client.get(
            f"/api/v1/kb/{kbid}/{kind}_strategies/strategy/{sid}"
        ).status_code == 404
    schema = client.get("/api/v1/nua/schema").json()
    assert "semantic_model" in schema["properties"]
    # model metadata: vectorset models resolve, unknown 404s
    client.post(f"/api/v1/kb/{kbid}/configuration",
                json={"generative_model": "gen-1"})
    assert client.get(
        f"/api/v1/kb/{kbid}/model/gen-1"
    ).json()["model_id"] == "gen-1"
    assert client.get(f"/api/v1/kb/{kbid}/model/nope").status_code == 404
    assert client.get(
        f"/api/v1/kb/{kbid}/models/gen-1/pytorch_model.bin"
    ).status_code == 404


def test_required_role_reader_posts():
    """Regression: resource-scoped retrieval POSTs are READER surface (they
    used to fall through to WRITER, 403ing reader tokens)."""
    from nucliadb_tpu_torch.standalone.auth import required_role

    for path in (
        "/api/v1/kb/k1/resource/r1/search",
        "/api/v1/kb/k1/resource/r1/ask",
        "/api/v1/kb/k1/slug/my-doc/search",
        "/api/v1/kb/k1/slug/my-doc/ask",
        "/api/v1/kb/k1/find",
        "/api/v1/kb/k1/ask",
    ):
        assert required_role("POST", path) == "READER", path
    # writes and forged suffixes stay WRITER
    for path in (
        "/api/v1/kb/k1/resources",
        "/api/v1/kb/k1/labelset/ask",
        "/api/v1/kb/k1/resource/r1/reindex",
    ):
        assert required_role("POST", path) == "WRITER", path


def test_required_role_options_open():
    """Regression: OPTIONS required READER, which broke credential-less CORS
    preflights under every authenticated policy (browsers never attach
    credentials to preflights)."""
    from nucliadb_tpu_torch.standalone.auth import required_role

    for path in (
        "/api/v1/kb/k1/resource/r1/file/f1/tusupload",
        "/api/v1/kb/k1/find",
        "/api/v1/kbs",
    ):
        assert required_role("OPTIONS", path) is None, path
    # non-preflight methods keep their roles
    assert required_role("GET", "/api/v1/kb/k1/resource/r1") == "READER"
    assert required_role("POST", "/api/v1/kbs") == "MANAGER"


def test_tus_slug_upload_and_purge_robustness(server):
    """Regressions: (1) slug-form TUS creation returned a Location with no
    PATCH/HEAD route registered, so the upload could never proceed;
    (2) purge_stale parsed ANY /kbs/ key containing '/tus/' as a session and
    crashed the whole gc tick on e.g. a resource slug 'a/tus/b'."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "tus-slug-kb"}).json()["uuid"]
    # poisoned slug: writes /kbs/{kbid}/rslugs/a/tus/b with non-JSON value
    client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "p", "slug": "a/tus/b"}
    )
    client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "s", "slug": "slugres"}
    ).json()["uuid"]

    base = f"/api/v1/kb/{kbid}/slug/slugres/file/doc/tusupload"
    data = b"slug-routed tus payload"
    created = client.post(
        base,
        headers={"tus-resumable": "1.0.0", "upload-length": str(len(data))},
    )
    assert created.status_code == 201, created.text
    loc = created.headers["location"]
    assert "/slug/slugres/" in loc

    head = client.request("HEAD", loc)
    assert head.status_code == 200 and head.headers["upload-offset"] == "0"

    patched = client.patch(
        loc,
        content=data,
        headers={
            "tus-resumable": "1.0.0",
            "upload-offset": "0",
            "content-type": "application/offset+octet-stream",
        },
    )
    assert patched.status_code == 204, patched.text
    assert patched.headers.get("tus-upload-finished") == "1"

    rid = client.get(f"/api/v1/kb/{kbid}/slug/slugres").json()["id"]
    got = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/download"
    )
    assert got.status_code == 200 and got.content == data

    # the gc tick must survive the poisoned key and purge nothing fresh
    assert app.tus.purge_stale() == 0
    # refcounted session locks drain once uploads settle
    assert app.tus._session_locks == {}


def test_export_roundtrips_vocab_and_blobs(server):
    """Regression: export used to serialize only config + resources —
    labelsets, entity groups, synonyms, learning config and file BLOBS were
    silently dropped (permanent data loss on the advertised backup path)."""
    import base64 as _b64

    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "exportfull"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/labelset/ls1",
        json={"title": "LS", "labels": [{"title": "a"}]},
    )
    client.post(
        f"/api/v1/kb/{kbid}/entitiesgroup/PEOPLE",
        json={"title": "People", "entities": {"ada": {"value": "ada"}}},
    )
    client.post(
        f"/api/v1/kb/{kbid}/custom-synonyms",
        json={"car": ["auto"]},
    )
    data = b"PDF-BYTES-HERE"
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "withfile",
            "files": {
                "f1": {
                    "file": {
                        "filename": "doc.bin",
                        "content_type": "application/octet-stream",
                        "payload": _b64.b64encode(data).decode(),
                    }
                }
            },
        },
    ).json()["uuid"]
    # the persisted payload must carry the REAL blob key (no '<rid>')
    shown = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}", params={"show": "values"}
    ).json()
    key = shown["files"]["f1"]["file"]["key"]
    assert "<rid>" not in key and rid in key

    blob = client.get(f"/api/v1/kb/{kbid}/export").content
    imported = client.post("/api/v1/kbs/import?slug=exportfull-copy", content=blob)
    new_kbid = imported.json()["uuid"]

    assert client.get(
        f"/api/v1/kb/{new_kbid}/labelset/ls1"
    ).json()["labels"][0]["title"] == "a"
    assert "PEOPLE" in client.get(
        f"/api/v1/kb/{new_kbid}/entitiesgroups"
    ).json()["groups"]
    syn = client.get(f"/api/v1/kb/{new_kbid}/custom-synonyms").json()
    assert (syn.get("synonyms") or syn)["car"] == ["auto"]
    # the blob came across and is downloadable from the NEW kb
    dl = client.get(
        f"/api/v1/kb/{new_kbid}/resource/{rid}/file/f1/download/field"
    )
    assert dl.status_code == 200 and dl.content == data


def test_find_request_alias_coercion():
    """Regression: string spellings of min_score/sort were silently popped
    and discarded instead of coerced or rejected."""
    from nucliadb_tpu_torch.models.api import FindRequest

    r = FindRequest.model_validate({"query": "q", "min_score": "0.5"})
    assert r.min_score_semantic == 0.5
    r2 = FindRequest.model_validate({"query": "q", "sort": "created"})
    assert r2.sort_field == "created"
    with pytest.raises(Exception):
        FindRequest.model_validate({"query": "q", "min_score": "abc"})
    with pytest.raises(Exception):
        FindRequest.model_validate({"query": "q", "sort": 17})


def test_http_malformed_requests_get_responses(server):
    """Regression: parse errors (bad request line, bad Content-Length,
    oversized body) escaped the handler and the client got NO response."""
    import socket

    client, app = server
    port = app.server.port

    def raw(data: bytes) -> bytes:
        s = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            s.sendall(data)
            out = b""
            while True:
                chunk = s.recv(4096)
                if not chunk:
                    break
                out += chunk
            return out
        finally:
            s.close()

    assert b"400" in raw(b"GARBAGE\r\n\r\n").split(b"\r\n", 1)[0]
    assert b"400" in raw(
        b"GET / HTTP/1.1\r\ncontent-length: abc\r\n\r\n"
    ).split(b"\r\n", 1)[0]
    assert b"413" in raw(
        b"POST /api/v1/kbs HTTP/1.1\r\ncontent-length: 999999999999\r\n\r\n"
    ).split(b"\r\n", 1)[0]
    # server still alive afterwards
    assert client.get("/health/ready").status_code == 200


def test_http_500_does_not_leak_traceback(server):
    """Regression: unhandled errors returned the full Python traceback to
    the client."""
    from nucliadb_tpu_torch.http.server import Request

    client, app = server

    def boom(request: Request):
        raise RuntimeError("kaboom secret-internal-state")

    app.server.router.add("GET", "/__test_boom", boom)
    resp = client.get("/__test_boom")
    assert resp.status_code == 500
    assert resp.json() == {"detail": "internal error"}
    assert "kaboom" not in resp.text and "Traceback" not in resp.text


def test_streaming_producer_failure_truncates(server):
    """Regression: a producer raising mid-stream was treated as clean EOF
    and the chunked terminator was written — clients saw a complete 200."""
    import httpx as _httpx

    from nucliadb_tpu_torch.http.server import Request, StreamingResponse

    client, app = server

    def stream(request: Request):
        def gen():
            yield "first chunk\n"
            raise RuntimeError("producer died")

        return StreamingResponse(gen(), content_type="application/x-ndjson")

    app.server.router.add("GET", "/__test_stream_fail", stream)
    with pytest.raises(_httpx.HTTPError):
        with client.stream("GET", "/__test_stream_fail") as resp:
            resp.read()


def test_security_object_alias(server):
    """Regression: the reference's `security: {groups: [...]}` spelling was
    silently DROPPED (pydantic extra=ignore) — requests ran unrestricted and
    returned resources the caller should not see."""
    client, app = server
    kbid = client.post(
        "/api/v1/kbs", json={"slug": "sec-alias", "vectorsets": {"m": {"dimension": 8}}}
    ).json()["uuid"]
    body = "classified vector doc"
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "secret",
            "texts": {"t": {"body": body}},
            "security": {"access_groups": ["staff"]},
            "embeddings": {"m": {"t": [{"start": 0, "end": len(body), "vector": [0.3] * 8}]}},
        },
    )
    app.node.wait_for_sync()
    base = {"query": "classified", "vector": [0.3] * 8, "vectorset": "m",
            "features": ["keyword", "semantic"]}
    outsider = client.post(
        f"/api/v1/kb/{kbid}/find", json={**base, "security": {"groups": ["outsiders"]}}
    ).json()
    staff = client.post(
        f"/api/v1/kb/{kbid}/find", json={**base, "security": {"groups": ["staff"]}}
    ).json()
    assert outsider["resources"] == {}
    assert len(staff["resources"]) == 1
    # malformed security objects 422 instead of running unrestricted
    bad = client.post(f"/api/v1/kb/{kbid}/find", json={**base, "security": "staff"})
    assert bad.status_code == 422


def test_fulltext_matches_serialize_resources(server):
    """Parity: /search with fulltext includes matched rids in `resources`
    (reference merge.py resources.update for the document leg)."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "ft-res"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "ft doc", "texts": {"t": {"body": "searchable fulltext body"}}},
    ).json()["uuid"]
    app.node.wait_for_sync()
    s = client.post(
        f"/api/v1/kb/{kbid}/search",
        json={"query": "searchable", "features": ["fulltext"]},
    ).json()
    assert [h["rid"] for h in s["fulltext"]["results"]] == [rid]
    assert rid in s["resources"] and s["resources"][rid]["title"] == "ft doc"


def test_security_object_rejects_wrong_key_and_get_param(server):
    """Regressions: (1) a dict security object with a wrong/missing 'groups'
    key silently ran unrestricted; (2) GET /find dropped security_groups."""
    client, app = server
    kbid = client.post(
        "/api/v1/kbs", json={"slug": "sec-keys"}
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "classified", "texts": {"t": {"body": "restricted body"}},
              "security": {"access_groups": ["staff"]}},
    )
    app.node.wait_for_sync()
    base = {"query": "restricted", "features": ["keyword"]}
    # wrong key shape -> 422, not unrestricted
    for bad_sec in ({"group": ["staff"]}, {"groups": "staff"}, {"Groups": ["x"]}):
        resp = client.post(f"/api/v1/kb/{kbid}/find", json={**base, "security": bad_sec})
        assert resp.status_code == 422, (bad_sec, resp.text)
    # GET spelling filters too
    got = client.get(
        f"/api/v1/kb/{kbid}/find",
        params={"query": "restricted", "features": "keyword",
                "security_groups": "outsiders"},
    ).json()
    assert got["resources"] == {}
    got2 = client.get(
        f"/api/v1/kb/{kbid}/find",
        params={"query": "restricted", "features": "keyword",
                "security_groups": "staff"},
    ).json()
    assert len(got2["resources"]) == 1


def test_graph_flat_payload_honors_security(server):
    """Regression: the flat /graph payload (source_value/target_value shape)
    ignored `security`/`show_hidden` — the boolean-expression mode applied
    them, so the flat shape was a security bypass."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "graph-sec"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "secret rel",
            "security": {"access_groups": ["staff"]},
            "usergenerated_relations": [
                {"relation": "ENTITY", "label": "works_at",
                 "from": {"value": "alice", "type": "entity"},
                 "to": {"value": "acme", "type": "entity"}},
            ],
        },
    )
    app.node.wait_for_sync()

    flat = {"source_value": "alice"}
    everyone = client.post(f"/api/v1/kb/{kbid}/graph", json=flat).json()
    outsider = client.post(
        f"/api/v1/kb/{kbid}/graph",
        json={**flat, "security": {"groups": ["outsiders"]}},
    ).json()
    staff = client.post(
        f"/api/v1/kb/{kbid}/graph",
        json={**flat, "security": {"groups": ["staff"]}},
    ).json()
    assert len(everyone["paths"]) == 1  # unrestricted callers still see it
    assert outsider["paths"] == []
    assert len(staff["paths"]) == 1


def test_graph_expr_security_fills_top_k(server):
    """Constrained expression queries fill top_k from below the cut (the old
    post-filtering dropped secured edges AFTER truncation and under-filled)."""
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "graph-fill"}).json()["uuid"]
    # 3 secret edges + 3 public edges, same pattern
    for i in range(3):
        client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={
                "title": f"secret{i}",
                "security": {"access_groups": ["staff"]},
                "usergenerated_relations": [
                    {"relation": "ENTITY", "label": "knows",
                     "from": {"value": "hub", "type": "entity"},
                     "to": {"value": f"s{i}", "type": "entity"}},
                ],
            },
        )
    for i in range(3):
        client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={
                "title": f"public{i}",
                "usergenerated_relations": [
                    {"relation": "ENTITY", "label": "knows",
                     "from": {"value": "hub", "type": "entity"},
                     "to": {"value": f"p{i}", "type": "entity"}},
                ],
            },
        )
    app.node.wait_for_sync()
    out = client.post(
        f"/api/v1/kb/{kbid}/graph",
        json={
            "query": {"prop": "source_node", "value": "hub"},
            "top_k": 3,
            "security": {"groups": ["outsiders"]},
        },
    ).json()
    targets = {p["target"] for p in out["paths"]}
    assert targets == {"p0", "p1", "p2"}, out

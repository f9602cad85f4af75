"""The scenarios of ``tests/test_rich_filter_expression.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules.
"""

import asyncio
import threading

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
        data_dir=str(tmp_path_factory.mktemp("richfilter")), host="127.0.0.1", port=0
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
    client = httpx.Client(base_url=f"http://127.0.0.1:{app.server.port}", timeout=60)

    kbid = client.post(
        "/api/v1/kbs", json={"slug": "rf", "vectorsets": {"m": {"dimension": DIM}}}
    ).json()["uuid"]

    def res(slug, title, body, **kw):
        payload = {
            "slug": slug,
            "title": title,
            "texts": {"t1": {"body": body, **kw.pop("text_extra", {})}},
            "embeddings": {"m": {"t1": [{"start": 0, "end": len(body),
                                         "vector": embed(body)}]}},
        }
        payload.update(kw)
        r = client.post(f"/api/v1/kb/{kbid}/resources", json=payload)
        assert r.status_code == 201, r.text
        return r.json()["uuid"]

    rids = {}
    rids["fox"] = res(
        "fox", "Fox doc", "the quick brown fox runs through the forest",
        usermetadata={"classifications": [{"labelset": "topic", "label": "animals"}]},
        origin={"tags": ["nature"], "source_id": "crawler-1",
                "metadata": {"team": "research"}, "path": "/docs/animals/foxes",
                "collaborators": ["alice"]},
        metadata={"language": "en", "languages": ["ca"]},
        key_values={"product": {"price": 10, "tags": ["sale", "new"],
                                "stock": {"gte": 5, "lte": 20}}},
    )
    rids["market"] = res(
        "market", "Market doc", "markets rallied on quick gains yesterday",
        usermetadata={"classifications": [{"labelset": "topic", "label": "finance"}]},
        origin={"tags": ["money"], "source_id": "crawler-2", "path": "/docs/finance"},
        metadata={"language": "fr"},
        key_values={"product": {"price": 99, "tags": ["clearance"]}},
    )
    rids["bear"] = res(
        "bear", "Bear doc", "a quick bear wanders the woods",
        usermetadata={"classifications": [{"labelset": "topic", "label": "animals"}]},
        text_extra={"format": "MARKDOWN"},
    )
    app.node.wait_for_sync()
    yield client, app, kbid, rids
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def find_rids(client, kbid, fe, rids, query="quick", **extra):
    body = {"query": query, "features": ["keyword"], "filter_expression": fe}
    body.update(extra)
    r = client.post(f"/api/v1/kb/{kbid}/find", json=body)
    assert r.status_code == 200, r.text
    inv = {v: k for k, v in rids.items()}
    return sorted(inv.get(rid, rid) for rid in r.json()["resources"])


def test_field_atoms(server):
    client, app, kbid, rids = server
    cases = [
        ({"field": {"prop": "label", "labelset": "topic", "label": "animals"}},
         ["bear", "fox"]),
        ({"field": {"prop": "label", "labelset": "topic"}},
         ["bear", "fox", "market"]),  # labelset alone matches all its labels
        ({"field": {"prop": "origin_tag", "tag": "nature"}}, ["fox"]),
        ({"field": {"prop": "origin_source", "id": "crawler-2"}}, ["market"]),
        ({"field": {"prop": "origin_metadata", "field": "team",
                    "value": "research"}}, ["fox"]),
        ({"field": {"prop": "origin_metadata", "field": "team"}}, ["fox"]),
        ({"field": {"prop": "origin_path", "prefix": "/docs/animals"}}, ["fox"]),
        ({"field": {"prop": "origin_path", "prefix": "/docs"}}, ["fox", "market"]),
        ({"field": {"prop": "origin_collaborator", "collaborator": "alice"}}, ["fox"]),
        ({"field": {"prop": "language", "language": "en"}}, ["fox"]),
        ({"field": {"prop": "language", "only_primary": True, "language": "ca"}}, []),
        ({"field": {"prop": "language", "language": "ca"}}, ["fox"]),  # secondary
        ({"field": {"prop": "keyword", "word": "forest"}}, ["fox"]),
        ({"field": {"prop": "resource", "slug": "bear"}}, ["bear"]),
        ({"field": {"prop": "resource", "id": rids["market"]}}, ["market"]),
        ({"field": {"prop": "field", "type": "text", "name": "t1"}},
         ["bear", "fox", "market"]),
        ({"field": {"prop": "field", "type": "file"}}, []),
        ({"field": {"prop": "field_mimetype", "type": "text",
                    "subtype": "markdown"}}, ["bear"]),
        ({"field": {"prop": "status", "status": "PROCESSED"}},
         ["bear", "fox", "market"]),
        # boolean composition
        ({"field": {"and": [
            {"prop": "label", "labelset": "topic", "label": "animals"},
            {"not": {"prop": "resource", "slug": "fox"}},
        ]}}, ["bear"]),
        ({"field": {"or": [
            {"prop": "origin_tag", "tag": "money"},
            {"prop": "keyword", "word": "forest"},
        ]}}, ["fox", "market"]),
    ]
    for fe, want in cases:
        assert find_rids(client, kbid, fe, rids) == want, fe


def test_date_atoms(server):
    client, app, kbid, rids = server
    import time

    now = time.time()
    fe = {"field": {"prop": "created", "since": now - 3600}}
    assert find_rids(client, kbid, fe, rids) == ["bear", "fox", "market"]
    fe = {"field": {"prop": "created", "until": now - 3600}}
    assert find_rids(client, kbid, fe, rids) == []
    fe = {"field": {"prop": "modified", "since": now - 3600, "until": now + 3600}}
    assert find_rids(client, kbid, fe, rids) == ["bear", "fox", "market"]


def test_paragraph_tree_and_operator(server):
    client, app, kbid, rids = server
    # paragraph kind: titles vs text blocks
    fe = {"paragraph": {"prop": "kind", "kind": "TITLE"}}
    r = client.post(f"/api/v1/kb/{kbid}/find",
                    json={"query": "doc", "features": ["keyword"],
                          "filter_expression": fe})
    matches = [m for res in r.json()["resources"].values()
               for f in res["fields"].values() for m in f["paragraphs"]]
    assert matches and all("/a/title/" in m for m in matches)

    # operator=and: field(finance) AND paragraph(kind TITLE) — the query
    # term only appears in the finance BODY (kind TEXT), so nothing passes
    # both sides ("yesterday" is not in the title)
    fe = {
        "field": {"prop": "label", "labelset": "topic", "label": "finance"},
        "paragraph": {"prop": "kind", "kind": "TITLE"},
        "operator": "and",
    }
    got = find_rids(client, kbid, fe, rids, query="yesterday")
    assert got == []  # its body paragraph is kind TEXT

    # operator=or: blocks matching EITHER side — the finance resource's
    # TEXT paragraph matches via the field side
    fe = {**fe, "operator": "or"}
    got = find_rids(client, kbid, fe, rids, query="yesterday")
    assert got == ["market"]


def test_operator_or_union_semantics(server):
    client, app, kbid, rids = server
    # field(nature tag) OR paragraph(animals label) = fox (field side)
    # union bear (paragraph side carries resource labels too)
    fe = {
        "field": {"prop": "origin_tag", "tag": "nature"},
        "paragraph": {"prop": "label", "labelset": "topic", "label": "animals"},
        "operator": "or",
    }
    assert find_rids(client, kbid, fe, rids) == ["bear", "fox"]
    # same with AND: only fox matches both sides
    assert find_rids(client, kbid, {**fe, "operator": "and"}, rids) == ["fox"]


def test_key_value_filters(server):
    client, app, kbid, rids = server
    cases = [
        ({"key_value": {"schema_id": "product", "key": "price", "eq": 10}}, ["fox"]),
        ({"key_value": {"schema_id": "product", "key": "price", "gte": 50}},
         ["market"]),
        ({"key_value": {"schema_id": "product", "key": "price",
                        "gte": 5, "lte": 50}}, ["fox"]),
        ({"key_value": {"schema_id": "product", "key": "tags",
                        "contains": "sale"}}, ["fox"]),
        ({"key_value": {"schema_id": "product", "key": "stock",
                        "contains": 7}}, ["fox"]),  # range containment
        ({"key_value": {"schema_id": "product", "key": "stock",
                        "contains": 50}}, []),
        ({"key_value": {"and": [
            {"schema_id": "product", "key": "price", "lte": 50},
            {"schema_id": "product", "key": "tags", "contains": "new"},
        ]}}, ["fox"]),
        # key_value AND field tree combine
        ({"field": {"prop": "label", "labelset": "topic", "label": "finance"},
          "key_value": {"schema_id": "product", "key": "price", "gte": 50}},
         ["market"]),
        ({"field": {"prop": "label", "labelset": "topic", "label": "animals"},
          "key_value": {"schema_id": "product", "key": "price", "gte": 50}},
         []),
    ]
    for fe, want in cases:
        assert find_rids(client, kbid, fe, rids) == want, fe


def test_rich_filters_on_suggest_and_catalog_and_graph(server):
    client, app, kbid, rids = server
    # suggest honors the field tree
    r = client.post(
        f"/api/v1/kb/{kbid}/suggest",
        json={"query": "qui", "filter_expression": {
            "field": {"prop": "origin_tag", "tag": "money"}}},
    )
    assert r.status_code == 200, r.text
    assert {p["rid"] for p in r.json()["paragraphs"]} == {rids["market"]}

    # catalog: field tree filters the listing
    r = client.post(
        f"/api/v1/kb/{kbid}/catalog",
        json={"filter_expression": {
            "field": {"prop": "label", "labelset": "topic", "label": "animals"}}},
    )
    assert r.status_code == 200, r.text
    assert {res["id"] for res in r.json()["resources"]} == {rids["fox"], rids["bear"]}
    # paragraph trees are meaningless on catalog -> 422
    r = client.post(
        f"/api/v1/kb/{kbid}/catalog",
        json={"filter_expression": {"paragraph": {"prop": "kind", "kind": "TITLE"}}},
    )
    assert r.status_code == 422

    # graph: field tree restricts edges by resource (none of these
    # resources carry relations, so just assert the plane accepts it)
    r = client.post(
        f"/api/v1/kb/{kbid}/graph",
        json={"query": {"prop": "path"},
              "filter_expression": {"field": {"prop": "resource",
                                              "slug": "fox"}}},
    )
    assert r.status_code == 200, r.text


def test_strict_validation(server):
    client, app, kbid, rids = server
    bad = [
        {"field": {"prop": "nope"}},
        {"field": {"prop": "label"}},  # missing labelset
        {"field": {"prop": "resource", "slug": "no-such-slug"}},
        {"field": {"prop": "created"}},  # needs since/until
        {"field": {"prop": "field", "type": "bogus"}},
        {"paragraph": {"prop": "keyword", "word": "x"}},  # not a paragraph prop
        {"key_value": {"schema_id": "s", "key": "k"}},  # no predicate
        {"operator": "xor", "field": {"prop": "keyword", "word": "x"}},
        # mixing rich and legacy shapes
        {"field": {"prop": "keyword", "word": "x"}, "literal": "/l/a/b"},
    ]
    for fe in bad:
        r = client.post(
            f"/api/v1/kb/{kbid}/find",
            json={"query": "quick", "features": ["keyword"],
                  "filter_expression": fe},
        )
        assert r.status_code == 422, (fe, r.status_code, r.text)


def test_legacy_tree_still_works(server):
    client, app, kbid, rids = server
    fe = {"any": [{"literal": "/l/topic/finance"},
                  {"literal": "/t/nature"}]}
    assert find_rids(client, kbid, fe, rids) == ["fox", "market"]

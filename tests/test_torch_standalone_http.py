"""The scenarios of ``tests/test_standalone_http.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules: the first half of its
tests (``test_torch_standalone_http2.py`` holds the second).
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


def test_http_full_flow(server):
    client, app = server
    # root + health
    assert client.get("/").json()["title"] == "nucliadb_tpu"
    assert client.get("/health/ready").json() == {"status": "ok"}

    # create kb
    resp = client.post(
        "/api/v1/kbs",
        json={
            "slug": "httpkb",
            "vectorsets": {"model1": {"dimension": DIM}},
        },
    )
    assert resp.status_code == 201, resp.text
    kbid = resp.json()["uuid"]
    assert client.get("/api/v1/kb/s/httpkb").json()["uuid"] == kbid
    kb_list = client.get("/api/v1/kbs").json()["kbs"]
    assert {"uuid": kbid, "slug": "httpkb"} in kb_list

    # create resources
    body = "the quick brown fox jumps over the lazy dog"
    resp = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "slug": "fox",
            "title": "Fox doc",
            "texts": {"text1": {"body": body}},
            "usermetadata": {
                "classifications": [{"labelset": "topic", "label": "animals"}]
            },
            "usergenerated_relations": [
                {
                    "relation": "ENTITY",
                    "label": "jumps over",
                    "from": {"value": "fox", "group": "animal"},
                    "to": {"value": "dog", "group": "animal"},
                }
            ],
            "embeddings": {
                "model1": {"text1": [{"start": 0, "end": len(body), "vector": embed(body)}]}
            },
        },
    )
    assert resp.status_code == 201, resp.text
    rid = resp.json()["uuid"]

    body2 = "markets rallied on tech gains"
    resp = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "Finance", "texts": {"text1": {"body": body2}}},
    )
    assert resp.status_code == 201

    # read back
    got = client.get(f"/api/v1/kb/{kbid}/resource/{rid}").json()
    assert got["title"] == "Fox doc"
    assert "embeddings" not in got
    assert client.get(f"/api/v1/kb/{kbid}/slug/fox").json()["id"] == rid

    # find (hybrid)
    resp = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "quick fox", "vector": embed(body), "top_k": 5},
    )
    assert resp.status_code == 200, resp.text
    results = resp.json()
    assert rid in results["resources"]
    paras = [
        p
        for f in results["resources"][rid]["fields"].values()
        for p in f["paragraphs"].values()
    ]
    assert any("quick brown fox" in p["text"] for p in paras)

    # suggest + catalog + graph + ask
    sugg = client.get(f"/api/v1/kb/{kbid}/suggest", params={"query": "qui"}).json()
    assert sugg["paragraphs"]
    cat = client.post(f"/api/v1/kb/{kbid}/catalog", json={"faceted": ["/l/topic"]}).json()
    assert cat["total"] >= 1
    graph = client.post(
        f"/api/v1/kb/{kbid}/graph", json={"source_value": "fox"}
    ).json()
    assert graph["paths"][0]["target"] == "dog"
    ask = client.post(
        f"/api/v1/kb/{kbid}/ask", json={"query": "quick fox", "vector": embed(body)},
        headers={"x-synchronous": "true"},
    ).json()
    assert ask["status"] in ("success", "no_generative_model")
    assert "fox" in ask["answer"]

    # update + delete resource
    resp = client.patch(
        f"/api/v1/kb/{kbid}/resource/{rid}", json={"title": "Fox doc 2"}
    )
    assert resp.status_code == 200
    assert client.get(f"/api/v1/kb/{kbid}/resource/{rid}").json()["title"] == "Fox doc 2"
    assert client.delete(f"/api/v1/kb/{kbid}/resource/{rid}").status_code == 204
    assert client.get(f"/api/v1/kb/{kbid}/resource/{rid}").status_code == 404

    # metrics endpoint
    assert b"ndbtpu" in client.get("/metrics").content or client.get("/metrics").status_code == 200

    # validation errors
    assert client.post(f"/api/v1/kb/{kbid}/find", content=b"{bad json").status_code == 422
    assert client.post("/api/v1/kbs", json={"slug": "httpkb"}).status_code == 409
    assert client.get("/api/v1/kb/nope").status_code == 404

    # vocabulary services
    assert (
        client.post(
            f"/api/v1/kb/{kbid}/labelset/topic",
            json={"title": "Topic", "labels": [{"title": "animals"}]},
        ).status_code
        == 201
    )
    assert "topic" in client.get(f"/api/v1/kb/{kbid}/labelsets").json()["labelsets"]
    assert client.get(f"/api/v1/kb/{kbid}/labelset/topic").json()["title"] == "Topic"
    assert (
        client.post(
            f"/api/v1/kb/{kbid}/entitiesgroup/animals",
            json={"title": "Animals", "entities": {"fox": {"value": "fox"}}},
        ).status_code
        == 201
    )
    assert client.get(f"/api/v1/kb/{kbid}/entitiesgroups").json()["groups"] == ["animals"]
    assert (
        client.post(
            f"/api/v1/kb/{kbid}/custom-synonyms", json={"finance": ["markets"]}
        ).status_code
        == 201
    )
    res = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "finance", "features": ["keyword"], "with_synonyms": True},
    ).json()
    assert len(res["resources"]) == 1  # matched via synonym "markets"

    # augment (rid was deleted above -> block carries an error) + learning config
    aug = client.post(
        f"/api/v1/kb/{kbid}/augment",
        json={"operations": [{"op": "field", "rid": rid, "field_id": "t/text1"}]},
    )
    assert aug.status_code == 200
    assert aug.json()["blocks"][0]["error"] == "not found"
    assert client.patch(
        f"/api/v1/kb/{kbid}/configuration", json={"semantic_model": "m"}
    ).json()["semantic_model"] == "m"

    # export/import + backup
    blob = client.get(f"/api/v1/kb/{kbid}/export").content
    imported = client.post("/api/v1/kbs/import?slug=copy", content=blob)
    assert imported.status_code == 201
    backup = client.post(f"/api/v1/kb/{kbid}/backup").json()
    assert backup["backup_id"] in client.get("/api/v1/backups").json()["backups"]

    # admin
    assert "merged" in client.post("/api/v1/admin/tick").json()
    shards_info = client.get(f"/api/v1/admin/shards/{kbid}").json()
    assert len(shards_info["shards"]) >= 1

    # delete kb
    assert client.delete(f"/api/v1/kb/{kbid}").status_code == 204
    assert client.get(f"/api/v1/kb/{kbid}").status_code == 404


def test_file_fields_and_ask_ndjson(server):
    client, app = server
    resp = client.post(
        "/api/v1/kbs", json={"slug": "files-kb", "vectorsets": {}}
    )
    kbid = resp.json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "With file", "texts": {"t": {"body": "report about foxes"}}},
    ).json()["uuid"]

    # upload + list + download a blob field
    data = b"PDFBYTES" * 100
    up = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc1/upload",
        params={"filename": "report.pdf"},
        content=data,
        headers={"content-type": "application/pdf"},
    )
    assert up.status_code == 201 and up.json()["size"] == len(data)
    files = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/files").json()["files"]
    assert files["doc1"]["filename"] == "report.pdf"
    down = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/file/doc1/download")
    assert down.content == data
    assert (
        client.get(f"/api/v1/kb/{kbid}/resource/{rid}/file/nope/download").status_code
        == 404
    )

    # ndjson ask stream
    import json as _json

    resp = client.post(
        f"/api/v1/kb/{kbid}/ask", params={"stream": "ndjson"},
        json={"query": "foxes"},
    )
    items = [_json.loads(line)["item"] for line in resp.text.strip().split("\n")]
    types = [i["type"] for i in items]
    assert types[0] == "retrieval" and types[-1] == "status"
    assert any(t == "answer" for t in types)

    # the DEFAULT (no X-Synchronous header) is the ndjson stream, matching
    # the reference's x_synchronous=False default (search/api/v1/ask.py)
    resp = client.post(f"/api/v1/kb/{kbid}/ask", json={"query": "foxes"})
    assert resp.headers.get("content-type", "").startswith("application/x-ndjson")
    assert all(_json.loads(line)["item"] for line in resp.text.strip().split("\n"))

    # ndjson is delivered chunked (a real stream, not one buffered body)
    assert resp.headers.get("transfer-encoding") == "chunked"

    # notifications cursor
    notes = client.get(f"/api/v1/kb/{kbid}/notifications").json()["notifications"]
    assert [n["action"] for n in notes] == ["created"]


def test_notifications_sse(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "sse-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "sse res"}
    ).json()["uuid"]

    import json as _json

    events = []
    with client.stream(
        "GET",
        f"/api/v1/kb/{kbid}/notifications",
        params={"timeout": 2},
        headers={"accept": "text/event-stream"},
    ) as resp:
        assert resp.status_code == 200
        assert resp.headers["content-type"].startswith("text/event-stream")
        assert resp.headers.get("transfer-encoding") == "chunked"
        for line in resp.iter_lines():
            if line.startswith("data: "):
                events.append(_json.loads(line[len("data: "):]))
                if len(events) >= 1:
                    break
    assert events and events[0]["action"] == "created" and events[0]["rid"] == rid


def test_tus_resumable_upload(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "tus-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "tus res"}
    ).json()["uuid"]

    base = f"/api/v1/kb/{kbid}/resource/{rid}/file/bigdoc/tusupload"

    # server capabilities
    opts = client.request("OPTIONS", base)
    assert opts.status_code == 204
    assert opts.headers["tus-resumable"] == "1.0.0"
    assert "creation-defer-length" in opts.headers["tus-extension"]

    import base64 as _b64

    data = b"0123456789abcdef" * 1000  # 16000 bytes
    meta = "filename " + _b64.b64encode(b"big.bin").decode() + ",content_type " + _b64.b64encode(b"application/x-bin").decode()
    created = client.post(
        base,
        headers={
            "tus-resumable": "1.0.0",
            "upload-length": str(len(data)),
            "upload-metadata": meta,
        },
    )
    assert created.status_code == 201, created.text
    loc = created.headers["location"]
    assert loc.startswith(base)

    # HEAD reports offset 0
    head = client.request("HEAD", loc)
    assert head.status_code == 200
    assert head.headers["upload-offset"] == "0"
    assert head.headers["upload-length"] == str(len(data))

    # three chunks; a wrong-offset PATCH is rejected with 409
    third = len(data) // 3
    chunks = [data[:third], data[third : 2 * third], data[2 * third :]]
    offset = 0
    for i, chunk in enumerate(chunks):
        resp = client.patch(
            loc,
            content=chunk,
            headers={
                "tus-resumable": "1.0.0",
                "upload-offset": str(offset),
                "content-type": "application/offset+octet-stream",
            },
        )
        assert resp.status_code == 204, resp.text
        offset += len(chunk)
        assert resp.headers["upload-offset"] == str(offset)
        if i == 0:
            bad = client.patch(
                loc,
                content=chunk,
                headers={"tus-resumable": "1.0.0", "upload-offset": "0"},
            )
            assert bad.status_code == 409
            # resume point: HEAD gives the committed offset
            assert client.request("HEAD", loc).headers["upload-offset"] == str(offset)
    assert resp.headers.get("tus-upload-finished") == "1"

    # the finished upload materialized as a file field
    files = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/files").json()["files"]
    assert files["bigdoc"]["filename"] == "big.bin"
    assert files["bigdoc"]["size"] == len(data)
    down = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/file/bigdoc/download")
    assert down.content == data
    # session is gone
    assert client.request("HEAD", loc).status_code == 404


def test_tus_kb_level_defer_length(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "tus-kb2"}).json()["uuid"]
    created = client.post(
        f"/api/v1/kb/{kbid}/tusupload",
        headers={"tus-resumable": "1.0.0", "upload-defer-length": "1"},
    )
    assert created.status_code == 201, created.text
    loc = created.headers["location"]
    rid = created.headers["ndb-resource"].rsplit("/", 1)[-1]

    # first chunk without knowing the total; final chunk declares the length
    resp = client.patch(
        loc, content=b"AAAA",
        headers={"tus-resumable": "1.0.0", "upload-offset": "0"},
    )
    assert resp.status_code == 204
    resp = client.patch(
        loc, content=b"BB",
        headers={"tus-resumable": "1.0.0", "upload-offset": "4", "upload-length": "6"},
    )
    assert resp.status_code == 204
    assert resp.headers.get("tus-upload-finished") == "1"
    down = client.get(f"/api/v1/kb/{kbid}/resource/{rid}/file/file/download")
    assert down.content == b"AAAABB"


def test_openapi_schema(server):
    client, app = server
    spec = client.get("/api/v1/openapi.json").json()
    assert spec["openapi"] == "3.1.0"
    paths = spec["paths"]
    # the whole route table is described
    assert "/api/v1/kb/{kbid}/find" in paths
    find = paths["/api/v1/kb/{kbid}/find"]["post"]
    assert find["requestBody"]["content"]["application/json"]["schema"]["$ref"].endswith(
        "FindRequest"
    )
    assert {"name": "kbid", "in": "path", "required": True, "schema": {"type": "string"}} in find[
        "parameters"
    ]
    schemas = spec["components"]["schemas"]
    assert "FindRequest" in schemas and "KnowledgeboxFindResults" in schemas
    # nested models are hoisted into shared components
    assert "FindParagraph" in schemas
    # TUS + SSE routes are present too
    assert "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload" in paths
    assert "/api/v1/kb/{kbid}/notifications" in paths


def test_file_upload_text_extraction(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "extract-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "doc holder"}
    ).json()["uuid"]

    # HTML upload -> tags stripped, script dropped, text searchable
    html = b"""<html><head><title>t</title><script>var x=1;</script></head>
    <body><h1>Quarterly Report</h1><p>The walrus population is thriving.</p></body></html>"""
    up = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/report/upload",
        params={"filename": "report.html"},
        content=html,
        headers={"content-type": "text/html"},
    )
    assert up.status_code == 201 and up.json()["extracted"] is True
    app._sync(force=True)
    res = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "walrus"}).json()
    assert rid in res["resources"]
    body = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}", params={"show": "values,extracted"}
    ).json()["texts"]["report"]["body"]
    assert "var x=1" not in body and "walrus population" in body

    # markdown via TUS also extracts on finalize
    md = b"# Notes\n\nthe yak herd moved north\n"
    loc = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/notes/tusupload",
        headers={
            "upload-length": str(len(md)),
            "upload-metadata": "filename " + __import__("base64").b64encode(b"notes.md").decode(),
        },
    ).headers["location"]
    fin = client.patch(loc, content=md, headers={"upload-offset": "0"})
    assert fin.headers.get("tus-upload-finished") == "1"
    app._sync(force=True)
    res = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "yak"}).json()
    assert rid in res["resources"]

    # binary formats pass through unextracted
    up = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/bin/upload",
        params={"filename": "x.pdf"},
        content=b"%PDF-1.4 binary",
        headers={"content-type": "application/pdf"},
    )
    assert up.json()["extracted"] is False


def test_resource_show_options(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "show-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "shown",
            "texts": {"t": {"body": "visible text"}},
            "usergenerated_relations": [
                {"relation": "ENTITY", "label": "l",
                 "from": {"value": "a"}, "to": {"value": "b"}}
            ],
            "security": {"access_groups": ["g1"]},
        },
    ).json()["uuid"]
    # extracted text field lands via upload
    client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/upload",
        params={"filename": "d.txt"}, content=b"hidden extracted text",
        headers={"content-type": "text/plain"},
    )

    base = f"/api/v1/kb/{kbid}/resource/{rid}"
    basic = client.get(base, params={"show": "basic"}).json()
    assert basic["title"] == "shown" and "texts" not in basic
    assert "usergenerated_relations" not in basic and "security" not in basic

    vals = client.get(base, params=[("show", "basic"), ("show", "values")]).json()
    assert vals["texts"]["t"]["body"] == "visible text"
    assert "doc" not in vals["texts"]  # extracted hidden unless requested

    extr = client.get(base, params={"show": "values,extracted"}).json()
    assert extr["texts"]["doc"]["format"] == "EXTRACTED"

    default = client.get(base).json()
    assert "texts" in default and "embeddings" not in default


def test_conversation_link_fields_and_counters(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "conv-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "Chat",
            "conversations": {
                "support": {
                    "messages": [
                        {"who": "user", "text": "my gizmo exploded"},
                        {"who": "agent", "text": "have you tried rebooting the gizmo?"},
                    ]
                }
            },
            "links": {
                "src": {"uri": "https://example.com/gizmo",
                        "title": "Gizmo manual", "description": "all about gizmos"},
            },
        },
    ).json()["uuid"]
    app._sync(force=True)

    # conversation messages are searchable paragraphs
    res = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "exploded"}).json()
    assert rid in res["resources"]
    paras = [
        p for f in res["resources"][rid]["fields"].values() for p in f["paragraphs"].values()
    ]
    assert any("exploded" in p["text"] for p in paras)
    # link title searchable too
    res = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "manual"}).json()
    assert rid in res["resources"]

    # per-field CRUD
    base = f"/api/v1/kb/{kbid}/resource/{rid}"
    got = client.get(f"{base}/conversation/support").json()
    assert len(got["messages"]) == 2
    ap = client.put(
        f"{base}/conversation/support/messages",
        json=[{"who": "user", "text": "rebooting fixed the quibble"}],
    )
    assert ap.status_code == 200 and ap.json()["messages"] == 3
    msgs = client.get(f"{base}/conversation/support/messages").json()
    assert msgs["total"] == 3
    app._sync(force=True)
    res = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "quibble"}).json()
    assert rid in res["resources"]

    assert client.get(f"{base}/link/src").json()["uri"] == "https://example.com/gizmo"
    put = client.put(f"{base}/text/extra", json={"body": "afterthought text"})
    assert put.status_code == 201
    assert client.get(f"{base}/text/extra").json()["body"] == "afterthought text"
    assert client.delete(f"{base}/text/extra").status_code == 204
    assert client.get(f"{base}/text/extra").status_code == 404

    # counters
    counts = client.get(f"/api/v1/kb/{kbid}/counters").json()
    assert counts["resources"] == 1 and counts["fields"] >= 3
    assert counts["paragraphs"] >= 4

    # reindex
    assert client.post(f"{base}/reindex").status_code == 200


def test_facets_feedback_summarize_export_status(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "misc-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "slug": "doc1",
            "title": "Doc",
            "texts": {"t": {"body": "First point. Second point. Third point. Fourth."}},
            "usermetadata": {"classifications": [{"labelset": "topic", "label": "a"}]},
        },
    ).json()["uuid"]
    app._sync(force=True)

    facets = client.post(
        f"/api/v1/kb/{kbid}/catalog/facets", json={"prefixes": ["/l/topic"]}
    ).json()["facets"]
    assert facets["/l/topic"]["/l/topic/a"] == 1

    assert client.post(
        f"/api/v1/kb/{kbid}/feedback",
        json={"ident": "q1", "good": True, "feedback": "nice"},
    ).status_code == 204
    assert client.post(f"/api/v1/kb/{kbid}/feedback", json={}).status_code == 422

    summ = client.post(
        f"/api/v1/kb/{kbid}/summarize", json={"resources": ["doc1"]}
    ).json()
    assert "First point." in summ["resources"]["doc1"]["summary"]
    assert "Fourth" not in summ["resources"]["doc1"]["summary"]  # extractive cut

    # async-API export/import parity
    exp = client.post(f"/api/v1/kb/{kbid}/export").json()
    st = client.get(f"/api/v1/kb/{kbid}/export/{exp['export_id']}/status").json()
    assert st["status"] == "finished"
    blob = client.get(f"/api/v1/kb/{kbid}/export/{exp['export_id']}").content
    kbid2 = client.post("/api/v1/kbs", json={"slug": "misc-copy"}).json()["uuid"]
    imp = client.post(f"/api/v1/kb/{kbid2}/import", content=blob).json()
    st = client.get(f"/api/v1/kb/{kbid2}/import/{imp['import_id']}/status").json()
    assert st["status"] == "finished"
    assert rid in [r["id"] for r in client.get(f"/api/v1/kb/{kbid2}/resources").json()["resources"]]


def test_slug_twins_and_key_value_fields(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "twin-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "slug": "twin-res",
            "title": "Twin",
            "key_values": {"specs": {"color": "red", "weight": 3}},
        },
    ).json()["uuid"]

    base_rid = f"/api/v1/kb/{kbid}/resource/{rid}"
    base_slug = f"/api/v1/kb/{kbid}/slug/twin-res"

    # key_value field CRUD via both addressings
    assert client.get(f"{base_rid}/key_value/specs").json()["color"] == "red"
    assert client.get(f"{base_slug}/key_value/specs").json()["color"] == "red"
    assert client.put(
        f"{base_slug}/key_value/specs", json={"color": "blue"}
    ).status_code == 201
    assert client.get(f"{base_rid}/key_value/specs").json() == {"color": "blue"}
    assert client.put(f"{base_rid}/key_value/bad", json=[1, 2]).status_code == 422

    # slug twins cover files, patch, reindex
    up = client.post(
        f"{base_slug}/file/doc/upload", params={"filename": "n.txt"},
        content=b"note text", headers={"content-type": "text/plain"},
    )
    assert up.status_code == 201
    assert client.get(f"{base_rid}/file/doc/download").content == b"note text"
    assert client.patch(f"{base_slug}", json={"title": "Twin 2"}).status_code == 200
    assert client.get(base_rid).json()["title"] == "Twin 2"
    assert client.post(f"{base_slug}/reindex").status_code == 200
    assert client.get(f"/api/v1/kb/{kbid}/slug/nope/key_value/specs").status_code == 404

    # delete via slug twin
    assert client.delete(base_slug).status_code == 204
    assert client.get(base_rid).status_code == 404


def test_search_configurations(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "cfg-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "A", "texts": {"t": {"body": "alpha beta gamma"}}},
    )
    app._sync(force=True)

    # saved config: keyword-only, top_k 1
    assert client.post(
        f"/api/v1/kb/{kbid}/search_configurations/kw_only",
        json={"kind": "find", "features": ["keyword"], "top_k": 1},
    ).status_code == 201
    assert "kw_only" in client.get(f"/api/v1/kb/{kbid}/search_configurations").json()
    got = client.get(f"/api/v1/kb/{kbid}/search_configurations/kw_only").json()
    assert got["top_k"] == 1

    # applied by name; request's own keys win over the preset
    res = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "alpha", "search_configuration": "kw_only"},
    )
    assert res.status_code == 200 and res.json()["page_size"] == 1
    res = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "alpha", "search_configuration": "kw_only", "top_k": 7},
    )
    assert res.json()["page_size"] == 7

    # unknown config -> 422; invalid body -> 422; delete -> gone
    assert client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "a", "search_configuration": "nope"},
    ).status_code == 422
    assert client.post(
        f"/api/v1/kb/{kbid}/search_configurations/bad", json={"top_k": "NaN"}
    ).status_code == 422
    assert client.delete(
        f"/api/v1/kb/{kbid}/search_configurations/kw_only"
    ).status_code == 204
    assert client.get(
        f"/api/v1/kb/{kbid}/search_configurations/kw_only"
    ).status_code == 404


def test_hydrate_processing_status_kv_schemas(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "hyd-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "H", "texts": {"t": {"body": "para one.\n\npara two."}}},
    ).json()["uuid"]
    app._sync(force=True)

    # hydrate paragraph + field ids
    res = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "para", "features": ["keyword"]}
    ).json()
    pid = next(
        p
        for f in res["resources"][rid]["fields"].values()
        for p in f["paragraphs"]
    )
    hyd = client.post(
        f"/api/v1/kb/{kbid}/hydrate",
        json={"paragraphs": [pid, "garbage"], "fields": [f"{rid}/t/t"]},
    ).json()["texts"]
    assert hyd[pid].startswith("para")
    assert hyd["garbage"] is None
    assert hyd[f"{rid}/t/t"] == "para one.\n\npara two."

    # processing status: synchronous ingestion -> completed
    st = client.get(f"/api/v1/kb/{kbid}/processing-status").json()
    assert st["results"][0]["resource_id"] == rid
    assert st["results"][0]["completed"] is True

    # kv schema validates key_value writes for the matching field name
    assert client.post(
        f"/api/v1/kb/{kbid}/kv-schemas/specs",
        json={
            "type": "object",
            "required": ["color"],
            "properties": {"color": {"type": "string"},
                           "weight": {"type": "number", "minimum": 0}},
        },
    ).status_code == 201
    assert "specs" in client.get(f"/api/v1/kb/{kbid}/kv-schemas").json()["schemas"]
    ok = client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/key_value/specs",
        json={"color": "red", "weight": 1.5},
    )
    assert ok.status_code == 201
    bad = client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/key_value/specs", json={"weight": -2}
    )
    assert bad.status_code == 422 and "required" in bad.json()["detail"]
    # create-time validation too
    assert client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "x", "key_values": {"specs": {"color": 7}}},
    ).status_code == 422
    # invalid schema rejected
    assert client.post(
        f"/api/v1/kb/{kbid}/kv-schemas/bad", json={"type": "wibble"}
    ).status_code == 422


def test_graph_nodes_relations(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "gn-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "G",
            "usergenerated_relations": [
                {"relation": "ENTITY", "label": "chases",
                 "from": {"value": "cat", "group": "animal"},
                 "to": {"value": "mouse", "group": "animal"}},
                {"relation": "ENTITY", "label": "eats",
                 "from": {"value": "cat", "group": "animal"},
                 "to": {"value": "fish", "group": "animal"}},
            ],
        },
    )
    app._sync(force=True)
    nodes = client.post(
        f"/api/v1/kb/{kbid}/graph/nodes", json={"source_value": "cat"}
    ).json()["nodes"]
    assert {n["value"] for n in nodes} == {"cat", "mouse", "fish"}
    rels = client.post(
        f"/api/v1/kb/{kbid}/graph/relations", json={"source_value": "cat"}
    ).json()["relations"]
    assert {x["label"] for x in rels} == {"chases", "eats"}


def test_auth_policies(tmp_path_factory):
    from nucliadb_tpu_torch.standalone.auth import AuthSettings

    def boot(auth):
        app = StandaloneApp(
            data_dir=str(tmp_path_factory.mktemp("auth")), host="127.0.0.1",
            port=0, auth=auth,
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
        return httpx.Client(base_url=f"http://127.0.0.1:{app.server.port}", timeout=30), loop

    # upstream_naive: identity + roles via trusted proxy headers
    client, loop = boot(AuthSettings(policy="upstream_naive"))
    try:
        assert client.get("/health/ready").status_code == 200  # open
        assert client.get("/api/v1/kbs").status_code == 401  # no headers
        reader = {"x-nucliadb-user": "u", "x-nucliadb-roles": "READER"}
        manager = {"x-nucliadb-user": "u", "x-nucliadb-roles": "MANAGER"}
        writer = {"x-nucliadb-user": "u", "x-nucliadb-roles": "READER;WRITER"}
        # KB enumeration is a management read
        assert client.get("/api/v1/kbs", headers=reader).status_code == 403
        assert client.get("/api/v1/kbs", headers=manager).status_code == 200
        assert client.post("/api/v1/kbs", json={"slug": "x"}, headers=reader).status_code == 403
        kbid = client.post(
            "/api/v1/kbs", json={"slug": "x"}, headers=manager
        ).json()["uuid"]
        assert client.post(
            f"/api/v1/kb/{kbid}/resources", json={"title": "t"}, headers=reader
        ).status_code == 403
        rid = client.post(
            f"/api/v1/kb/{kbid}/resources", json={"title": "t"}, headers=writer
        ).json()["uuid"]
        # find is a READER surface even though it's a POST
        assert client.post(
            f"/api/v1/kb/{kbid}/find", json={"query": "t"}, headers=reader
        ).status_code == 200
        # KB delete needs MANAGER
        assert client.delete(f"/api/v1/kb/{kbid}", headers=writer).status_code == 403
        assert client.delete(f"/api/v1/kb/{kbid}", headers=manager).status_code == 204
    finally:
        client.close()
        loop.call_soon_threadsafe(loop.stop)

    # api_key: static bearer tokens -> roles
    client, loop = boot(
        AuthSettings(policy="api_key", api_keys={"sekrit": ["READER", "WRITER", "MANAGER"]})
    )
    try:
        assert client.get("/api/v1/kbs").status_code == 401
        assert client.get(
            "/api/v1/kbs", headers={"authorization": "Bearer wrong"}
        ).status_code == 401
        assert client.get(
            "/api/v1/kbs", headers={"authorization": "Bearer sekrit"}
        ).status_code == 200  # token has MANAGER
    finally:
        client.close()
        loop.call_soon_threadsafe(loop.stop)


def test_vectorset_lifecycle_and_backup_delete(server):
    client, app = server
    kbid = client.post(
        "/api/v1/kbs",
        json={"slug": "vs-kb", "vectorsets": {"m1": {"dimension": DIM}}},
    ).json()["uuid"]
    # add + list
    assert client.post(
        f"/api/v1/kb/{kbid}/vectorsets/m2", json={"dimension": DIM}
    ).status_code == 201
    vs = client.get(f"/api/v1/kb/{kbid}/vectorsets").json()["vectorsets"]
    assert set(vs) == {"m1", "m2"}

    # index into both, then drop m2: searches on m1 still work
    body = "vectors galore"
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "V",
            "texts": {"t": {"body": body}},
            "embeddings": {
                "m1": {"t": [{"start": 0, "end": 5, "vector": embed(body)}]},
                "m2": {"t": [{"start": 0, "end": 5, "vector": embed(body)}]},
            },
        },
    )
    app._sync(force=True)
    assert client.delete(f"/api/v1/kb/{kbid}/vectorsets/m2").status_code == 204
    assert set(client.get(f"/api/v1/kb/{kbid}/vectorsets").json()["vectorsets"]) == {"m1"}
    res = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "vectors", "vector": embed(body), "vectorset": "m1"},
    )
    assert res.status_code == 200 and res.json()["resources"]
    # deleted vectorset is rejected
    assert client.delete(f"/api/v1/kb/{kbid}/vectorsets/m2").status_code == 404

    # backups: create, list, delete
    backup_id = client.post(f"/api/v1/kb/{kbid}/backup").json()["backup_id"]
    assert backup_id in client.get("/api/v1/backups").json()["backups"]
    assert client.delete(f"/api/v1/backups/{backup_id}").status_code == 204
    assert backup_id not in client.get("/api/v1/backups").json()["backups"]
    assert client.delete(f"/api/v1/backups/{backup_id}").status_code == 404


def test_predict_proxy_and_models(tmp_path_factory):
    from nucliadb_tpu_torch.search.predict import LocalPredictEngine

    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("pred")), host="127.0.0.1", port=0,
        predict=LocalPredictEngine(generator=lambda p, ctx: f"answer to {p}"),
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
    try:
        kbid = client.post("/api/v1/kbs", json={"slug": "pred"}).json()["uuid"]
        emb = client.post(
            f"/api/v1/kb/{kbid}/predict/sentence", json={"text": "hello"}
        ).json()["data"]
        assert len(emb) == 256  # HashingEncoder default dimension
        ans = client.post(
            f"/api/v1/kb/{kbid}/predict/chat", json={"question": "why?"}
        ).json()["answer"]
        assert ans == "answer to why?"
        assert client.post(
            f"/api/v1/kb/{kbid}/predict/nope", json={}
        ).status_code == 404
        assert client.get(f"/api/v1/kb/{kbid}/models").json() == {"models": []}
        # the full predict client surface: rerank / rephrase / tokens / summarize
        scores = client.post(
            f"/api/v1/kb/{kbid}/predict/rerank",
            json={"query": "fast fox", "passages": ["a fast fox", "slow snail"]},
        ).json()["scores"]
        assert len(scores) == 2 and scores[0] > scores[1]
        reph = client.post(
            f"/api/v1/kb/{kbid}/predict/rephrase",
            json={"query": "and the second?", "chat_history": [
                {"author": "user", "text": "who wrote the first book?"}]},
        ).json()["rephrased"]
        assert reph  # generator-backed: a standalone-question rewrite
        ents = client.post(
            f"/api/v1/kb/{kbid}/predict/tokens",
            json={"text": "I met Marie Curie in Paris"},
        ).json()["entities"]
        assert any(e["text"] == "Marie Curie" for e in ents)
        summ = client.post(
            f"/api/v1/kb/{kbid}/predict/summarize",
            json={"texts": ["First doc. More.", "Second doc. Extra."]},
        ).json()["summary"]
        assert summ
        # with a predict engine, /ask generates and /find can embed queries
        client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={"title": "T", "texts": {"t": {"body": "some grounding text"}}},
        )
        app._sync(force=True)
        ask = client.post(
            f"/api/v1/kb/{kbid}/ask", json={"query": "grounding"},
            headers={"x-synchronous": "true"},
        ).json()
        assert ask["status"] == "success" and ask["answer"].startswith("answer to")
    finally:
        client.close()
        loop.call_soon_threadsafe(loop.stop)


def test_predict_proxy_without_engine(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "nopred"}).json()["uuid"]
    assert client.post(
        f"/api/v1/kb/{kbid}/predict/sentence", json={"text": "x"}
    ).status_code == 412


def test_run_launcher_subprocess(tmp_path):
    """The `python -m nucliadb_tpu_torch.standalone.run` binary boots, enforces
    auth flags, and serves (parity: the reference's nucliadb binary)."""
    import socket
    import subprocess
    import sys
    import time as _time

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = (
        "import sys; sys.argv = ['run', '--data-dir', %r, '--host', '127.0.0.1',"
        " '--port', '%d', '--auth-policy', 'api_key', '--api-key', 'tok=READER;WRITER;MANAGER',"
        " '--device', 'cpu'];"
        "from nucliadb_tpu_torch.standalone.run import main; main()"
    ) % (str(tmp_path / "data"), port)
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    try:
        client = httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=5)
        for _ in range(100):
            try:
                if client.get("/health/ready").status_code == 200:
                    break
            except httpx.TransportError:
                _time.sleep(0.2)
        else:
            raise AssertionError("server did not come up")
        assert client.get("/api/v1/kbs").status_code == 401
        assert client.get(
            "/api/v1/kbs", headers={"authorization": "Bearer tok"}
        ).status_code == 200
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_auth_no_escalation_via_path_suffix(tmp_path_factory):
    """Regression: POST routes whose final path segment is a client-chosen
    name like 'ask' must not classify as READER; reader-only GETs must not
    reach management surfaces (KB listing, exports, backups)."""
    from nucliadb_tpu_torch.standalone.auth import AuthSettings

    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("esc")), host="127.0.0.1", port=0,
        auth=AuthSettings(policy="upstream_naive"),
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
    reader = {"x-nucliadb-user": "u", "x-nucliadb-roles": "READER"}
    manager = {"x-nucliadb-user": "u", "x-nucliadb-roles": "MANAGER"}
    try:
        kbid = client.post("/api/v1/kbs", json={"slug": "esc"}, headers=manager).json()["uuid"]
        # write routes with reader-bait names stay WRITER-gated
        for path, body in (
            (f"/api/v1/kb/{kbid}/labelset/ask", {"title": "x"}),
            (f"/api/v1/kb/{kbid}/kv-schemas/find", {"type": "object"}),
            (f"/api/v1/kb/{kbid}/search_configurations/ask", {"top_k": 1}),
            (f"/api/v1/kb/{kbid}/entitiesgroup/search", {"title": "x"}),
        ):
            assert client.post(path, json=body, headers=reader).status_code == 403, path
        # genuine retrieval POSTs remain READER
        assert client.post(
            f"/api/v1/kb/{kbid}/find", json={"query": "x"}, headers=reader
        ).status_code == 200
        # management reads need MANAGER
        assert client.get("/api/v1/kbs", headers=reader).status_code == 403
        assert client.get(f"/api/v1/kb/{kbid}/export", headers=reader).status_code == 403
        assert client.get("/api/v1/backups", headers=reader).status_code == 403
        assert client.get("/api/v1/kbs", headers=manager).status_code == 200
        # plain reads still READER
        assert client.get(f"/api/v1/kb/{kbid}", headers=reader).status_code == 200
    finally:
        client.close()
        loop.call_soon_threadsafe(loop.stop)


def test_kv_schema_enforced_on_patch(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "kvp"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "r"}
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/kv-schemas/specs",
        json={"type": "object", "required": ["color"]},
    )
    bad = client.patch(
        f"/api/v1/kb/{kbid}/resource/{rid}",
        json={"key_values": {"specs": {"nope": 1}}},
    )
    assert bad.status_code == 422
    ok = client.patch(
        f"/api/v1/kb/{kbid}/resource/{rid}",
        json={"key_values": {"specs": {"color": "red"}}},
    )
    assert ok.status_code == 200


def test_tus_head_defer_length(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "tusdl"}).json()["uuid"]
    loc = client.post(
        f"/api/v1/kb/{kbid}/tusupload", headers={"upload-defer-length": "1"}
    ).headers["location"]
    head = client.request("HEAD", loc)
    assert head.headers.get("upload-defer-length") == "1"
    assert "upload-length" not in head.headers


def test_audit_events_and_loglevel(server):
    client, app = server
    from nucliadb_tpu_torch.common.audit import AUDIT_STREAM

    kbid = client.post("/api/v1/kbs", json={"slug": "auditkb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "A", "texts": {"t": {"body": "auditable fox text"}}},
    ).json()["uuid"]
    client.patch(f"/api/v1/kb/{kbid}/resource/{rid}", json={"title": "A2"})
    client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "fox", "features": ["keyword"]},
        headers={"x-nucliadb-user": "alice", "x-ndb-client": "dashboard"},
    )
    client.post(f"/api/v1/kb/{kbid}/suggest", json={"query": "fo"})
    client.delete(f"/api/v1/kb/{kbid}/resource/{rid}")

    import json as _json

    app.audit.flush()  # audit is buffered (fire-and-forget, reference parity)
    events = [
        _json.loads(m.payload)
        for m in app.bus.scan(AUDIT_STREAM, subject_prefix=f"audit.{kbid}")
    ]
    types = [e["type"] for e in events]
    assert types == ["new", "modified", "search", "suggest", "deleted"]
    search_ev = events[types.index("search")]
    assert search_ev["user"] == "alice"
    assert search_ev["client_type"] == "dashboard"
    assert search_ev["duration_ms"] > 0
    assert search_ev["detail"]["query"] == "fox"

    # dynamic log level
    import logging

    resp = client.post(
        "/api/v1/admin/loglevel", json={"logger": "nucliadb_tpu.test", "level": "debug"}
    )
    assert resp.json() == {"logger": "nucliadb_tpu.test", "level": "DEBUG"}
    assert logging.getLogger("nucliadb_tpu.test").level == logging.DEBUG
    assert client.post("/api/v1/admin/loglevel", json={"level": "nope"}).status_code == 422


def test_patch_kb_config(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "patchkb", "title": "Old"}).json()["uuid"]
    out = client.patch(
        f"/api/v1/kb/{kbid}", json={"title": "New", "slug": "patched-kb"}
    ).json()
    assert out["config"]["title"] == "New"
    # slug remap: old gone, new resolves
    assert client.get("/api/v1/kb/s/patched-kb").json()["uuid"] == kbid
    assert client.get("/api/v1/kb/s/patchkb").status_code == 404
    # conflicting slug is a 409
    client.post("/api/v1/kbs", json={"slug": "other-kb"})
    assert client.patch(f"/api/v1/kb/{kbid}", json={"slug": "other-kb"}).status_code == 409


def test_patch_kb_validates_types(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "valkb"}).json()["uuid"]
    # invalid value type is rejected with 422 and the config stays readable
    assert client.patch(f"/api/v1/kb/{kbid}", json={"title": 123}).status_code == 422
    assert client.get(f"/api/v1/kb/{kbid}").status_code == 200


def test_retrieve_endpoint(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "retr-kb"}).json()["uuid"]
    for i, body in enumerate(
        ["the quick brown fox jumps", "lazy dogs sleep all day", "foxes are quick animals"]
    ):
        client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={"title": f"r{i}", "texts": {"t": {"body": body}}},
        )
    out = client.post(
        f"/api/v1/kb/{kbid}/retrieve",
        json={"query": {"keyword": "quick fox"}, "top_k": 5},
    )
    assert out.status_code == 200, out.text
    matches = out.json()["matches"]
    assert matches, "expected keyword matches"
    top = matches[0]
    # score history carries the index score plus the fused score
    assert top["score"]["source"] == "rank_fusion"
    assert top["score"]["type"] == "rrf"
    kinds = {h["type"] for h in top["score"]["history"]}
    assert "keyword" in kinds and "rrf" in kinds
    assert "quick" in top["text"] or "fox" in top["text"]
    # raw string query selects both legs; with no vectorset it degrades to keyword
    out2 = client.post(
        f"/api/v1/kb/{kbid}/retrieve", json={"query": "lazy dogs"}
    )
    assert out2.status_code == 200, out2.text
    assert out2.json()["matches"]
    # weighted fusion reports wCombSUM as the fused score type
    out3 = client.post(
        f"/api/v1/kb/{kbid}/retrieve",
        json={"query": {"keyword": "quick"}, "rank_fusion": "weighted"},
    ).json()
    assert out3["matches"][0]["score"]["type"] == "wCombSUM"


def test_resource_scoped_search_and_ask(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "rscope-kb"}).json()["uuid"]
    rid1 = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "alpha", "slug": "alpha-doc",
              "texts": {"t": {"body": "shared term in alpha resource"}}},
    ).json()["uuid"]
    rid2 = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "beta",
              "texts": {"t": {"body": "shared term in beta resource"}}},
    ).json()["uuid"]

    # resource-scoped search only surfaces paragraphs of that resource
    out = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid1}/search", params={"query": "shared term"}
    )
    assert out.status_code == 200, out.text
    hits = out.json()["paragraphs"]["results"]
    assert hits and all(h["rid"] == rid1 for h in hits)
    assert "alpha" in hits[0]["text"]

    # slug twin answers too
    out_slug = client.get(
        f"/api/v1/kb/{kbid}/slug/alpha-doc/search", params={"query": "shared"}
    )
    assert out_slug.status_code == 200
    assert out_slug.json()["paragraphs"]["results"]

    # scoped ask grounds only on the target resource
    ask = client.post(
        f"/api/v1/kb/{kbid}/resource/{rid2}/ask",
        json={"query": "shared term"},
        headers={"x-synchronous": "true"},
    )
    assert ask.status_code == 200, ask.text
    body = ask.json()
    assert rid2 in body["retrieval"]["resources"]
    assert rid1 not in body["retrieval"]["resources"]

    # unknown resource is a 404
    assert client.get(
        f"/api/v1/kb/{kbid}/resource/nope/search", params={"query": "x"}
    ).status_code == 404

    # run-agents: embedded fallback reports fields unchanged
    agents = client.post(f"/api/v1/kb/{kbid}/resource/{rid1}/run-agents", json={})
    assert agents.status_code == 200, agents.text
    res = agents.json()["results"]
    assert "/t/t" in res and res["/t/t"]["changed"] is False


def test_trainset_partitions_and_streaming(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "train-rest-kb"}).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "doc",
            "texts": {"t": {"body": "one sentence. another sentence."}},
            "usermetadata": {"classifications": [{"labelset": "topic", "label": "a"}]},
        },
    )
    parts = client.get(f"/api/v1/kb/{kbid}/trainset").json()["partitions"]
    assert parts, "kb should expose at least one partition (shard)"
    assert client.get(
        f"/api/v1/kb/{kbid}/trainset/{parts[0][:4]}"
    ).json()["partitions"] == [p for p in parts if p.startswith(parts[0][:4])]

    # reference-style body with "type" streams Arrow IPC bytes
    resp = client.post(
        f"/api/v1/kb/{kbid}/trainset/{parts[0]}",
        json={"type": "FIELD_CLASSIFICATION", "batch_size": 8},
    )
    assert resp.status_code == 200, resp.text
    assert resp.headers["content-type"].startswith("application/octet-stream")
    import io
    import pyarrow as pa

    with pa.ipc.open_stream(io.BytesIO(resp.content)) as reader:
        rows = sum(rb.num_rows for rb in reader)
    assert rows >= 1

    # unknown task type -> 422
    assert client.post(
        f"/api/v1/kb/{kbid}/trainset/{parts[0]}", json={"type": "NOPE"}
    ).status_code == 422


def test_download_routes_and_ranges(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "dl-kb"}).json()["uuid"]
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources", json={"title": "dl", "slug": "dl-doc"}
    ).json()["uuid"]
    content = b"0123456789abcdef"
    client.post(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/upload",
        params={"filename": "doc.txt"}, content=content,
        headers={"content-type": "text/plain"},
    )

    # plain download + the reference /download/field spelling
    for path in (
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/download",
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/download/field",
        f"/api/v1/kb/{kbid}/slug/dl-doc/file/doc/download/field",
    ):
        got = client.get(path)
        assert got.status_code == 200, (path, got.text)
        assert got.content == content
        assert got.headers["accept-ranges"] == "bytes"

    # range requests: middle, suffix, open-ended, unsatisfiable
    url = f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/download"
    got = client.get(url, headers={"range": "bytes=4-7"})
    assert got.status_code == 206 and got.content == b"4567"
    assert got.headers["content-range"] == "bytes 4-7/16"
    assert client.get(url, headers={"range": "bytes=-4"}).content == b"cdef"
    assert client.get(url, headers={"range": "bytes=12-"}).content == b"cdef"
    assert client.get(url, headers={"range": "bytes=99-"}).status_code == 416

    # extracted artifact download (the locally-extracted text)
    ext = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/file/doc/download/extracted/text"
    )
    assert ext.status_code == 200 and ext.content == content

    # conversation attachments: b64 payload in, stored + served back
    import base64

    att = base64.b64encode(b"attached-bytes").decode()
    client.put(
        f"/api/v1/kb/{kbid}/resource/{rid}/conversation/chat/messages",
        json=[{"text": "see attachment", "ident": "m1",
               "files": [{"filename": "a.bin", "payload": att}]}],
    )
    # stored message no longer carries the inline payload
    msgs = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/conversation/chat/messages"
    ).json()["messages"]
    assert msgs[0]["files"][0]["payload"] is None
    assert msgs[0]["files"][0]["size"] == len(b"attached-bytes")
    got = client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/conversation/chat/download/field/m1/0"
    )
    assert got.status_code == 200 and got.content == b"attached-bytes"
    assert client.get(
        f"/api/v1/kb/{kbid}/resource/{rid}/conversation/chat/download/field/m1/5"
    ).status_code == 404


def test_hidden_resources(server):
    client, app = server
    # hiding requires the KB to enable hidden resources
    plain = client.post("/api/v1/kbs", json={"slug": "nohide-kb"}).json()["uuid"]
    resp = client.post(
        f"/api/v1/kb/{plain}/resources", json={"title": "x", "hidden": True}
    )
    assert resp.status_code == 422

    kbid = client.post(
        "/api/v1/kbs", json={"slug": "hide-kb", "hidden_resources_enabled": True}
    ).json()["uuid"]
    vis = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "visible", "texts": {"t": {"body": "common token visible"}}},
    ).json()["uuid"]
    hid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "hidden", "hidden": True,
              "texts": {"t": {"body": "common token hidden"}}},
    ).json()["uuid"]

    # keyword find: hidden excluded by default, shown with show_hidden
    out = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "common token"}).json()
    assert vis in out["resources"] and hid not in out["resources"]
    out = client.post(
        f"/api/v1/kb/{kbid}/find", json={"query": "common token", "show_hidden": True}
    ).json()
    assert vis in out["resources"] and hid in out["resources"]

    # suggest never surfaces hidden resources
    sugg = client.post(
        f"/api/v1/kb/{kbid}/suggest", json={"query": "common"}
    ).json()
    assert all(p["rid"] != hid for p in sugg["paragraphs"])

    # catalog hidden filter: True -> only hidden, False -> only visible
    cat_hidden = client.post(
        f"/api/v1/kb/{kbid}/catalog", json={"hidden": True}
    ).json()
    assert [r["id"] for r in cat_hidden["resources"]] == [hid]
    cat_visible = client.post(
        f"/api/v1/kb/{kbid}/catalog", json={"hidden": False}
    ).json()
    assert [r["id"] for r in cat_visible["resources"]] == [vis]

    # un-hide via PATCH -> appears in default find (searches lag writes by
    # the app's ~200ms sync debounce, so wait past it)
    import time as _time

    client.patch(f"/api/v1/kb/{kbid}/resource/{hid}", json={"hidden": False})
    _time.sleep(0.25)
    out = client.post(f"/api/v1/kb/{kbid}/find", json={"query": "common token"}).json()
    assert hid in out["resources"]

    # hide_on_creation: new resources default to hidden
    kbid2 = client.post(
        "/api/v1/kbs",
        json={"slug": "autohide-kb", "hidden_resources_enabled": True,
              "hidden_resources_hide_on_creation": True},
    ).json()["uuid"]
    auto = client.post(
        f"/api/v1/kb/{kbid2}/resources",
        json={"title": "auto", "texts": {"t": {"body": "auto hidden body"}}},
    ).json()["uuid"]
    out = client.post(f"/api/v1/kb/{kbid2}/find", json={"query": "auto hidden"}).json()
    assert auto not in out["resources"]
    assert client.get(f"/api/v1/kb/{kbid2}/resource/{auto}").json()["hidden"] is True


def test_find_resource_filters(server):
    client, app = server
    kbid = client.post("/api/v1/kbs", json={"slug": "rfilt-kb"}).json()["uuid"]
    rid1 = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "one", "texts": {"t": {"body": "filtered term here"}}},
    ).json()["uuid"]
    client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"title": "two", "texts": {"t": {"body": "filtered term there"}}},
    )
    out = client.post(
        f"/api/v1/kb/{kbid}/find",
        json={"query": "filtered term", "resource_filters": [rid1]},
    ).json()
    assert list(out["resources"]) == [rid1]

"""The scenarios of ``tests/test_e2e_flow.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules.
"""

import asyncio
import base64
import threading
import time

import httpx
import pytest

from tests.torch_test_helpers import standalone_app

StandaloneApp = standalone_app("nucliadb_tpu_torch")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("e2e")), host="127.0.0.1", port=0
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
    client = httpx.Client(
        base_url=f"http://127.0.0.1:{app.server.port}", timeout=60
    )
    yield client, app
    client.close()
    loop.call_soon_threadsafe(loop.stop)


IMAGE = b"iVBORw0KGgoAAAANSUhEUgAAABAAAAAQCAYAAAAf8/9hAAABjElEQVR42mNk"


def wait_processed(client, kbid, rid, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        resp = client.get(f"/api/v1/kb/{kbid}/resource/{rid}")
        resp.raise_for_status()
        if resp.json()["metadata"]["status"] == "PROCESSED":
            return
        time.sleep(0.2)
    raise AssertionError(f"resource {rid} never reached PROCESSED")


def test_e2e_flow(server):
    client, app = server

    # versions (e2e/test_e2e.py:54-63)
    data = client.get("/api/v1/versions").json()
    assert data["nucliadb"]["installed"]
    assert "latest" in data["nucliadb"]

    # config-check (test_config_check)
    resp = client.get("/api/v1/config-check")
    assert resp.status_code == 200
    assert "nua_api_key" in resp.json()

    # KB
    kbid = client.post("/api/v1/kbs", json={"slug": "e2e"}).json()["uuid"]

    # text resource + processed wait (test_resource_processed)
    rid = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "title": "Soccer doc",
            "texts": {"body": {"body": "Soccer is called soccer from association football."}},
        },
    ).json()["uuid"]
    wait_processed(client, kbid, rid)

    # b64 file upload in the resource payload + download roundtrip
    # (test_b64_file_upload)
    resp = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={
            "files": {
                "image": {
                    "file": {
                        "filename": "image.png",
                        "content_type": "image/png",
                        "payload": base64.b64encode(IMAGE).decode("utf-8"),
                    }
                }
            }
        },
    )
    assert resp.status_code == 201, resp.text
    img_rid = resp.json()["uuid"]
    wait_processed(client, kbid, img_rid)
    resp = client.get(
        f"/api/v1/kb/{kbid}/resource/{img_rid}/file/image/download/field"
    )
    assert resp.status_code == 200
    assert resp.content == IMAGE
    # bad base64 422s without creating anything
    bad = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"files": {"f": {"file": {"payload": "!!not-base64!!"}}}},
    )
    assert bad.status_code == 422

    # ask over the KB (test_search shape: keyword+relations, citations)
    resp = client.post(
        f"/api/v1/kb/{kbid}/ask",
        headers={"x-synchronous": "true"},
        json={
            "query": "Why is soccer called soccer?",
            "features": ["keyword", "relations"],
            "citations": True,
            "debug": True,
        },
    )
    assert resp.status_code == 200, resp.text
    ask = resp.json()
    retrieval = ask.get("retrieval") or ask.get("retrieval_results") or {}
    assert retrieval.get("resources"), ask

    # learning config (test_learning_config): unknown field -> 422
    resp = client.post(
        f"/api/v1/kb/{kbid}/configuration", json={"foo": "bar"}
    )
    assert resp.status_code == 422
    resp = client.post(
        f"/api/v1/kb/{kbid}/configuration",
        json={"generative_model": "local-echo", "semantic_model": "model1"},
    )
    assert resp.status_code == 200
    resp = client.get(f"/api/v1/kb/{kbid}/configuration")
    assert resp.status_code == 200
    assert resp.json()["generative_model"] == "local-echo"
    # schema lists the known fields and forbids extras
    schema = client.get(f"/api/v1/kb/{kbid}/schema").json()
    assert schema["additionalProperties"] is False
    assert "generative_model" in schema["properties"]
    # models + generative providers
    assert client.get(f"/api/v1/kb/{kbid}/models").status_code == 200
    providers = client.get(f"/api/v1/kb/{kbid}/generative_providers").json()
    assert providers["providers"]["local"]["default"] == "local-echo"

    # mimetypes (test_mimetypes): uncommon content types are accepted
    for ext, mimetype in [
        (".pptx", "application/vnd.openxmlformats-officedocument.presentationml.presentation"),
        (".ods", "application/vnd.oasis.opendocument.spreadsheet"),
        (".epub", "application/epub+zip"),
        (".scad", "application/x-openscad"),
    ]:
        resp = client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={
                "title": f"file{ext}",
                "files": {
                    "f": {
                        "file": {
                            "filename": f"file{ext}",
                            "content_type": mimetype,
                            "payload": base64.b64encode(b"content").decode(),
                        }
                    }
                },
            },
        )
        assert resp.status_code == 201, (ext, resp.text)
        wait_processed(client, kbid, resp.json()["uuid"])

    # final consistency: listing sees every resource created above
    listing = client.get(
        f"/api/v1/kb/{kbid}/resources", params={"size": 100}
    ).json()
    assert len(listing["resources"]) == 6

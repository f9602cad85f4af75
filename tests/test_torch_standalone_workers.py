"""The scenarios of ``tests/test_multiworker.py`` on the port: the port's
``python -m nucliadb_tpu_torch.standalone.run --device cpu --workers 2``
(its replica runs the port's entry point too) and the port's read
classification.
"""

import json
import os
import socket
import subprocess
import sys
import time

import httpx
import pytest

from nucliadb_tpu_torch.http import Request
from nucliadb_tpu_torch.standalone.workers import is_read_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _req(method, path):
    return Request(method=method, path=path, params={}, query={},
                   headers={}, body=b"")


def test_read_request_classification():
    assert is_read_request(_req("GET", "/api/v1/kb/k/resource/r"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/find"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/ask"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/resource/r/ask"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/graph/nodes"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/catalog"))
    assert is_read_request(_req("POST", "/api/v1/kb/k/predict/chat"))
    assert not is_read_request(_req("POST", "/api/v1/kbs"))
    assert not is_read_request(_req("POST", "/api/v1/kb/k/resources"))
    assert not is_read_request(_req("PATCH", "/api/v1/kb/k/resource/r"))
    assert not is_read_request(_req("DELETE", "/api/v1/kb/k/resource/r"))
    assert not is_read_request(_req("POST", "/api/v1/kb/k/vectorsets/v"))


def test_multiworker_end_to_end(tmp_path):
    port = _free_port()
    data_dir = str(tmp_path / "data")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + env.get("PYTHONPATH", "").split(os.pathsep)
    ).strip(os.pathsep)
    proc = subprocess.Popen(
        [sys.executable, "-m", "nucliadb_tpu_torch.standalone.run",
         "--data-dir", data_dir, "--host", "127.0.0.1", "--port", str(port),
         "--workers", "2", "--bg-interval", "2", "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        # wait for BOTH listeners (primary writes primary.json after binding
        # its private port; the replica prints once it is up)
        deadline = time.time() + 120
        client = None
        while time.time() < deadline:
            try:
                client = httpx.Client(
                    base_url=f"http://127.0.0.1:{port}", timeout=60
                )
                if client.get("/health/ready").status_code == 200:
                    break
            except Exception:
                time.sleep(0.5)
        assert client is not None
        while time.time() < deadline:
            if os.path.exists(os.path.join(data_dir, "primary.json")):
                break
            time.sleep(0.2)
        time.sleep(2.0)  # give the replica time to boot its listener

        # writes land regardless of which worker accepts the connection:
        # new connections per request scatter across both listeners
        kbid = None
        for attempt in range(3):
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
                r = c.post("/api/v1/kbs", json={"slug": f"mw{attempt}"})
                assert r.status_code == 201, r.text
                if kbid is None:
                    kbid = r.json()["uuid"]
        rids = []
        for i in range(6):
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
                r = c.post(
                    f"/api/v1/kb/{kbid}/resources",
                    json={"slug": f"r{i}", "title": f"doc {i}",
                          "texts": {"t": {"body": f"the quick brown fox number {i}"}}},
                )
                assert r.status_code == 201, r.text
                rids.append(r.json()["uuid"])

        # reads converge on EVERY worker (replica searcher sync <= ~1s):
        # spread many fresh connections so both listeners serve some
        deadline = time.time() + 60
        ok_rounds = 0
        while time.time() < deadline and ok_rounds < 6:
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
                r = c.post(f"/api/v1/kb/{kbid}/find",
                           json={"query": "quick fox", "features": ["keyword"]})
                assert r.status_code == 200, r.text
                if len(r.json()["resources"]) == 6:
                    ok_rounds += 1
                else:
                    ok_rounds = 0
                    time.sleep(0.5)
        assert ok_rounds >= 6, "replica never converged to the ingested state"

        # resource GET by slug works across workers too
        for _ in range(4):
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
                r = c.get(f"/api/v1/kb/{kbid}/slug/r0")
                assert r.status_code == 200, r.text
                assert r.json()["title"] == "doc 0"

        # a write THROUGH whatever worker accepts is visible after sync
        with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
            r = c.delete(f"/api/v1/kb/{kbid}/resource/{rids[0]}")
            assert r.status_code in (200, 204), r.text
        deadline = time.time() + 60
        while time.time() < deadline:
            with httpx.Client(base_url=f"http://127.0.0.1:{port}", timeout=60) as c:
                r = c.post(f"/api/v1/kb/{kbid}/find",
                           json={"query": "quick fox", "features": ["keyword"]})
                if len(r.json()["resources"]) == 5:
                    break
            time.sleep(0.5)
        else:
            raise AssertionError("delete never became visible on all workers")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
        # reap the replica (child of the primary; terminate() above asks the
        # primary's asyncio loop to shut down, which terminates replicas)
        time.sleep(1.0)

"""The scenarios of ``tests/test_trainset_stress.py`` on the port: the port's ``StandaloneApp`` on the CPU.

The reference file's own docstring:

Concurrent trainset-export stress — the pyarrow-flake repro bed.

History (STATUS.md "Known flake" + train/arrow_ipc.py forensic trail):
concurrent HTTP trainset exports rarely segfaulted the interpreter inside
pyarrow's WRITE machinery under this process's thread/allocator mix (XLA
CPU client + grpc/upb + arrow pools), ~1 in 3 full-suite runs. The root fix
was removing the native write path entirely: exports now emit Arrow IPC
bytes from the repo's pure-Python writer (train/arrow_ipc.py), with pyarrow
kept as the READ side so every parse is a two-implementation format check.

This test reconstructs the exact crash shape — many worker threads running
streamed AND file-partition exports concurrently with query load, repeated
— and would have caught the original fault (a segfault kills the process,
not just the assertion). With the pure-Python writer it must be boringly
stable; every emitted stream must still parse with REAL pyarrow.
"""

import asyncio
import io
import threading

import httpx
import numpy as np
import pyarrow as pa
import pytest

from tests.torch_test_helpers import standalone_app

StandaloneApp = standalone_app("nucliadb_tpu_torch")

DIM = 16
ROUNDS = 3
THREADS = 6


def embed(text):
    r = np.random.default_rng(abs(hash(text)) % (2**31))
    v = r.standard_normal(DIM).astype(np.float32)
    return (v / np.linalg.norm(v)).tolist()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    app = StandaloneApp(
        data_dir=str(tmp_path_factory.mktemp("stress")), host="127.0.0.1", port=0
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
    client = httpx.Client(
        base_url=f"http://127.0.0.1:{app.server.port}", timeout=120
    )
    resp = client.post(
        "/api/v1/kbs",
        json={"slug": "stress", "vectorsets": {"m": {"dimension": DIM}}},
    )
    kbid = resp.json()["uuid"]
    for i in range(12):
        body = f"stress document number {i} with a quick brown fox inside"
        r = client.post(
            f"/api/v1/kb/{kbid}/resources",
            json={
                "title": f"doc {i}",
                "texts": {"t": {"body": body}},
                "usermetadata": {
                    "classifications": [
                        {"labelset": "topic", "label": "even" if i % 2 == 0 else "odd"}
                    ]
                },
                "embeddings": {"m": {"t": [{"start": 0, "end": len(body),
                                            "vector": embed(body)}]}},
            },
        )
        assert r.status_code == 201, r.text
    app.node.wait_for_sync()
    yield client, app, kbid
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_concurrent_trainset_exports_are_stable(server):
    client, app, kbid = server
    base = f"http://127.0.0.1:{app.server.port}"
    errors: list = []
    parsed_rows: list = []
    lock = threading.Lock()
    tasks = ["paragraph_classification", "field_classification", "sentences"]

    def worker(ti: int):
        cc = httpx.Client(base_url=base, timeout=120)
        try:
            for rnd in range(ROUNDS):
                task = tasks[(ti + rnd) % len(tasks)]
                # streamed Arrow IPC bytes (the original crash shape)
                r = cc.post(
                    f"/api/v1/kb/{kbid}/trainset/{task}",
                    json={"type": task, "batch_size": 4},
                )
                assert r.status_code == 200, r.text
                table = pa.ipc.open_stream(io.BytesIO(r.content)).read_all()
                assert table.num_rows > 0
                # file-partition export racing the streams
                r = cc.post(
                    f"/api/v1/kb/{kbid}/trainset/{task}",
                    json={"batch_size": 4},
                )
                assert r.status_code == 201, r.text
                # concurrent query load (the full-suite mix that crashed)
                r = cc.post(
                    f"/api/v1/kb/{kbid}/find",
                    json={"query": "quick fox", "features": ["keyword"]},
                )
                assert r.status_code == 200, r.text
                with lock:
                    parsed_rows.append(int(table.num_rows))
        except BaseException as e:  # noqa: BLE001 — collected for the report
            with lock:
                errors.append(e)
        finally:
            cc.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors[:3]
    assert len(parsed_rows) == THREADS * ROUNDS
    assert all(n > 0 for n in parsed_rows)

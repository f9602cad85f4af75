"""The scenarios of ``tests/test_ask_streaming.py`` on the port: the same requests
against the port's ``StandaloneApp`` on the CPU (``standalone_app``
binds ``device="cpu"``) and the port's modules.
"""

import asyncio
import json
import threading

import httpx
import numpy as np
import pytest

from nucliadb_tpu_torch.search.predict import HashingEncoder, LocalPredictEngine
from tests.torch_test_helpers import standalone_app

StandaloneApp = standalone_app("nucliadb_tpu_torch")

DIM = 16
CHUNKS = ["Answer part one. ", "Part two. ", "Part three."]


class GatedGenerator:
    """Yields one chunk per release() — the test controls production so the
    transport's incrementality is provable (a buffered-response server would
    deadlock the first read)."""

    def __init__(self):
        self.release_sem = threading.Semaphore(0)
        self.produced = 0

    def __call__(self, prompt, context):
        for c in CHUNKS:
            assert self.release_sem.acquire(timeout=30), "generator starved"
            self.produced += 1
            yield c


@pytest.fixture()
def server(tmp_path):
    gen = GatedGenerator()
    app = StandaloneApp(
        data_dir=str(tmp_path / "standalone"), host="127.0.0.1", port=0,
        predict=LocalPredictEngine(
            encoder=HashingEncoder(DIM), stream_generator=gen
        ),
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
    resp = client.post(
        "/api/v1/kbs",
        json={"slug": "askkb", "vectorsets": {"m": {"dimension": DIM}}},
    )
    kbid = resp.json()["uuid"]
    resp = client.post(
        f"/api/v1/kb/{kbid}/resources",
        json={"slug": "fox", "title": "Fox doc",
              "texts": {"t1": {"body": "the quick brown fox jumps"}}},
    )
    assert resp.status_code == 201, resp.text
    yield client, kbid, gen
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_ask_streams_chunks_as_produced(server):
    client, kbid, gen = server
    with client.stream(
        "POST", f"/api/v1/kb/{kbid}/ask", json={"query": "quick fox"}
    ) as resp:
        assert resp.status_code == 200
        lines = resp.iter_lines()

        # retrieval item arrives BEFORE any generation happened
        first = json.loads(next(lines))
        assert first["item"]["type"] == "retrieval"
        assert gen.produced == 0

        # each answer item arrives right after its chunk is produced,
        # while later chunks are still unproduced
        for i, expected in enumerate(CHUNKS):
            gen.release_sem.release()
            item = json.loads(next(lines))["item"]
            assert item == {"type": "answer", "text": expected}
            assert gen.produced == i + 1

        tail = [json.loads(l)["item"]["type"] for l in lines if l.strip()]
        assert tail == ["citations", "status"]


def test_ask_synchronous_joins_stream(server):
    client, kbid, gen = server
    for _ in CHUNKS:
        gen.release_sem.release()
    resp = client.post(
        f"/api/v1/kb/{kbid}/ask", json={"query": "quick fox"},
        headers={"x-synchronous": "true"},
    )
    assert resp.status_code == 200
    assert resp.json()["answer"] == "".join(CHUNKS)


def test_budget_cuts_stream_without_draining_model():
    """max_tokens stops consuming the generator once the budget is spent."""
    from nucliadb_tpu_torch.search.find import SearchService

    consumed = []

    def chunks():
        for i in range(100):
            consumed.append(i)
            yield f"word{i} "

    out = list(SearchService._budget_chunks(chunks(), max_tokens=5))
    assert len(consumed) == 5  # not 100: the model stops being polled
    assert " ".join(c.strip() for c in out).split() == [
        "word0", "word1", "word2", "word3", "word4",
    ]


def test_generate_stream_default_single_chunk():
    engine = LocalPredictEngine(generator=lambda p, c: "full answer")
    assert list(engine.generate_stream("kb", "q", [])) == ["full answer"]
    # stream_generator also backs the blocking generate()
    engine = LocalPredictEngine(stream_generator=lambda p, c: iter(["a ", "b"]))
    assert engine.generate("kb", "q", []) == "a b"

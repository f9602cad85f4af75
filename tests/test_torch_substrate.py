"""The scenarios of ``tests/test_substrate.py`` on the port: the port's substrate clients and server, and component processes of the port on the CPU.

The reference file's own docstring:

Network substrate: remote metadata/bus/KV/blob backends over gRPC.

Parity target: the reference's components scale out against network
services — PG metadata (nidx/src/metadata.rs:37-100), NATS ingestion
(nidx/src/indexer.rs:121-149), object-store segments. Round 1's sqlite/file
backends required a shared filesystem; the substrate server makes true
multi-host component deployment possible. The e2e test launches separate
OS processes with SEPARATE data dirs: one serves the substrate, one
ingests through it, one searches through it.
"""

import socket
import subprocess
import sys
import time

import pytest

from nucliadb_tpu_torch.substrate import (
    RemoteBus,
    RemoteDriver,
    RemoteMetadataStore,
    RemoteStorage,
    SubstrateServer,
)
from nucliadb_tpu_torch.types import Seq


@pytest.fixture()
def substrate(tmp_path):
    server = SubstrateServer(str(tmp_path / "substrate"))
    server.start()
    addr = f"127.0.0.1:{server.port}"
    yield server, addr
    server.stop()


def test_remote_metadata_roundtrip(substrate):
    _, addr = substrate
    meta = RemoteMetadataStore(addr)
    s1, s2 = meta.next_seq(), meta.next_seq()
    assert int(s2) == int(s1) + 1 and int(meta.last_seq()) == int(s2)
    meta.create_shard("s1", "kb1", {"x": 1})
    shard = meta.get_shard("s1")
    assert shard.kbid == "kb1" and shard.config == {"x": 1}
    idx = meta.create_index("s1", "text", "text", {"cfg": True})
    seg = meta.create_segment(idx.id, Seq(5), 10, tags=["hidden"],
                              index_metadata={"kind": "text"})
    assert seg.seq == Seq(5) and seg.tags == ["hidden"]
    assert meta.ready_segments(idx.id) == []  # not ready yet
    meta.commit_operation(
        ready_segments=[seg.id],
        deletions=[(idx.id, Seq(6), ["r1/"])],
        touched_indexes=[idx.id],
    )
    ready = meta.ready_segments(idx.id)
    assert [s.id for s in ready] == [seg.id]
    assert ready[0].storage_key == seg.storage_key
    assert meta.deletions_for_index(idx.id) == [("r1/", Seq(6))]
    # merge job lifecycle over the wire
    job_id = meta.enqueue_merge(idx.id, Seq(7), [seg.id])
    job = meta.take_merge_job()
    assert job is not None and job.id == job_id
    assert [s.id for s in meta.merge_job_segments(job.id)] == [seg.id]
    meta.finish_merge_job(job.id)
    assert meta.pending_merge_jobs() == 0
    meta.close()


def test_remote_bus_ordered_consume(substrate):
    _, addr = substrate
    bus = RemoteBus(addr)
    s1 = bus.publish("st", "p.0", b"one")
    s2 = bus.publish("st", "p.0", b"two")
    assert (s1, s2) == (1, 2)
    m1 = bus.next("st", "c1")
    assert (m1.seq, m1.payload) == (1, b"one")
    # strictly ordered: seq 2 held while 1 is leased
    assert bus.next("st", "c1") is None
    bus.ack("st", "c1", m1.seq)
    m2 = bus.next("st", "c1")
    assert m2.payload == b"two"
    bus.ack("st", "c1", m2.seq)
    assert bus.ack_floor("st", "c1") == 2
    assert bus.pending("st", "c1") == 0
    scans = bus.scan("st", after_seq=0)
    assert [m.payload for m in scans] == [b"one", b"two"]
    bus.close()


def test_remote_kv_transactions(substrate):
    _, addr = substrate
    kv = RemoteDriver(addr)
    with kv as txn:
        txn.set("a/1", b"v1")
        txn.set("a/2", b"v2")
        txn.set("b/1", b"v3")
        # read-your-writes inside the txn
        assert txn.get("a/1") == b"v1"
        assert sorted(txn.keys("a/")) == ["a/1", "a/2"]
    with kv as txn:
        assert txn.batch_get(["a/1", "nope", "b/1"]) == [b"v1", None, b"v3"]
        txn.delete("a/1")
        assert txn.get("a/1") is None  # buffered delete visible
        assert txn.count("a/") == 1
    with kv as txn:
        assert txn.get("a/1") is None  # committed
        txn.delete_by_prefix("a/")
        txn.set("a/9", b"v9")  # set after prefix delete survives
        assert list(txn.keys("a/")) == ["a/9"]
    with kv as txn:
        assert list(txn.keys("a/")) == ["a/9"]
    # abort discards the buffer
    txn = kv.transaction()
    txn.set("c/1", b"x")
    txn.abort()
    with kv as t2:
        assert t2.get("c/1") is None
    # cross-process lock primitives forward atomically
    assert kv.compare_and_swap("lock", None, b"me")
    assert not kv.compare_and_swap("lock", None, b"you")
    assert kv.delete_if("lock", b"me")
    kv.close()


def test_remote_storage_segments(substrate, tmp_path):
    _, addr = substrate
    from nucliadb_tpu_torch.storage.storage import download_segment, upload_segment

    blob = RemoteStorage(addr)
    blob.put("k/1", b"hello")
    assert blob.get("k/1") == b"hello"
    assert blob.exists("k/1") and not blob.exists("k/2")
    assert list(blob.list("k/")) == ["k/1"]
    with pytest.raises((KeyError, FileNotFoundError)):
        blob.get("missing")
    # a segment round-trips through the remote store
    seg_dir = tmp_path / "seg"
    seg_dir.mkdir()
    (seg_dir / "data.bin").write_bytes(b"\x00" * 1024)
    upload_segment(blob, "segments/1/1.tar", str(seg_dir))
    out = tmp_path / "out"
    download_segment(blob, "segments/1/1.tar", str(out))
    assert (out / "data.bin").read_bytes() == b"\x00" * 1024
    blob.delete("k/1")
    assert not blob.exists("k/1")
    blob.close()


# --------------------------------------------------------------------------
# multi-process component mode
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_component(tmp_path, name, components, extra_args):
    code = (
        "import sys; sys.argv = ['run'] + %r;"
        "from nucliadb_tpu_torch.component.run import main; main()"
    ) % (components + ["--data-dir", str(tmp_path / name), "--device", "cpu"] + extra_args)
    return subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def _wait_port(port, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.3)
    raise AssertionError(f"port {port} never came up")


def test_multi_host_component_mode(tmp_path):
    """Three OS processes, three SEPARATE data dirs, shared state only via
    the substrate network plane: A owns the data (scheduler+worker+
    substrate server), B ingests (writer gRPC), C searches (searcher gRPC).
    """
    sub_port = _free_port()
    writer_port = _free_port()
    search_port = _free_port()

    a = _spawn_component(
        tmp_path, "a", ["scheduler", "worker"],
        ["--serve-substrate", f"127.0.0.1:{sub_port}"],
    )
    procs = [a]
    try:
        _wait_port(sub_port)
        b = _spawn_component(
            tmp_path, "b", ["writer", "ingest"],
            ["--substrate", f"127.0.0.1:{sub_port}",
             "--writer-address", f"127.0.0.1:{writer_port}"],
        )
        procs.append(b)
        c = _spawn_component(
            tmp_path, "c", ["searcher"],
            ["--substrate", f"127.0.0.1:{sub_port}",
             "--grpc-address", f"127.0.0.1:{search_port}"],
        )
        procs.append(c)
        _wait_port(writer_port)
        _wait_port(search_port)

        from nucliadb_tpu_torch.grpc_plane import WriterClient
        from nucliadb_tpu_torch.grpc_plane.client import NodeClient

        writer = WriterClient(f"127.0.0.1:{writer_port}", timeout=120)
        kbid = writer.new_kb({"slug": "mh", "title": "multi-host"})
        out = writer.process_message(
            kbid, "create",
            payload={
                "title": "doc one",
                "texts": {"body": {"body": "distributed quantum flux search"}},
            },
        )
        assert out["rid"]

        node = NodeClient(f"127.0.0.1:{search_port}", timeout=120)
        shards = node.list_shards(kbid)
        assert len(shards) >= 1
        shard_id = shards[0]["id"] if isinstance(shards[0], dict) else shards[0]

        from nucliadb_tpu_torch.shard import ShardSearchRequest

        deadline = time.time() + 120
        hits = []
        while time.time() < deadline:
            resp = node.search(
                shard_id, ShardSearchRequest(body="quantum flux", top_k=5)
            )
            if resp.paragraph is not None and resp.paragraph.hits:
                hits = resp.paragraph.hits
                break
            time.sleep(1.0)
        assert hits, "searcher never served the ingested doc over the substrate"
        assert hits[0].rid == out["rid"]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for p in procs:
            out = p.stdout.read().decode(errors="replace") if p.stdout else ""
            sys.stderr.write(f"--- component output ---\n{out[-3000:]}\n")


def test_remote_kv_concurrent_with_blocks(substrate):
    """Regression: concurrent ``with driver`` blocks from different threads
    must each commit their OWN buffer (a shared txn attribute let one
    thread's exit commit another thread's half-built transaction)."""
    import threading

    _, addr = substrate
    kv = RemoteDriver(addr)
    n_threads, n_keys = 8, 25
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(t):
        try:
            barrier.wait()
            with kv as txn:
                for i in range(n_keys):
                    txn.set(f"w{t}/{i:02d}", f"{t}:{i}".encode())
                # interleave: reads see only this thread's buffer
                assert txn.count(f"w{t}/") == n_keys
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    with kv as txn:
        for t in range(n_threads):
            assert txn.count(f"w{t}/") == n_keys, f"thread {t} writes lost"
            assert txn.get(f"w{t}/00") == f"{t}:0".encode()
    kv.close()


def test_remote_bus_watch_redelivers_on_callback_error(substrate):
    _, addr = substrate
    bus = RemoteBus(addr)
    seen = []
    fail_once = {"armed": True}

    def callback(msg):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("transient consumer error")
        seen.append(bytes(msg.payload))

    bus.watch("wt", callback)
    bus.publish("wt", "subj", b"m1")
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and b"m1" not in seen:
        time.sleep(0.05)
    # the failed delivery must be retried (cursor not advanced past it)
    assert seen == [b"m1"]
    bus.close()

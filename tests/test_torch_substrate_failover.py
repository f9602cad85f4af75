"""The scenarios of ``tests/test_substrate_failover.py`` on the port: the port's substrate HA pair.

The reference file's own docstring:

Substrate warm standby: bootstrap snapshot + synchronous op shipping +
kill-primary promotion with ZERO acked-write loss.

The reference's HA posture comes from PostgreSQL replication
(nidx/src/metadata.rs:37-100 assumes an HA-able PG); the substrate's
equivalent is a follower SubstrateServer the primary bootstraps with a full
snapshot and then ships every mutating RPC to synchronously — inside the
same critical section as local execution, BEFORE the client's ack. Killing
the primary therefore never loses a write a client saw acked (VERDICT r4
task 9)."""

import threading

import grpc
import msgpack
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
def pair(tmp_path):
    primary = SubstrateServer(str(tmp_path / "primary"))
    primary.start()
    standby = SubstrateServer(str(tmp_path / "standby"), follower=True)
    standby.start()
    yield primary, f"127.0.0.1:{primary.port}", standby, f"127.0.0.1:{standby.port}"
    primary.stop(0)
    standby.stop(0)


def _repl(addr, method, *args):
    """Operator-side replication-plane RPC (e.g. promote over the wire)."""
    with grpc.insecure_channel(addr) as chan:
        fn = chan.unary_unary(
            "/ndbtpu.Substrate/Call",
            request_serializer=msgpack.packb,
            response_deserializer=msgpack.unpackb,
        )
        out = fn({"t": "repl", "m": method, "a": list(args)}, timeout=10.0)
    if "err" in out:
        raise RuntimeError(out["err"])
    return out.get("v")


def test_standby_serves_nothing_until_promoted(pair):
    _, _, standby, standby_addr = pair
    kv = RemoteDriver(standby_addr)
    with pytest.raises(ValueError, match="not promoted"):
        kv._call("get", "any")
    kv.close()


def test_failover_zero_acked_write_loss(pair):
    primary, primary_addr, standby, standby_addr = pair
    kv = RemoteDriver(primary_addr)
    meta = RemoteMetadataStore(primary_addr)
    bus = RemoteBus(primary_addr)
    blob = RemoteStorage(primary_addr)

    # state BEFORE attach — must arrive via the bootstrap snapshot
    with kv as txn:
        txn.set("pre/a", b"1")
    meta.create_shard("s1", "kb1", {"x": 1})
    bus.publish("st", "p.0", b"m-pre")
    blob.put("segments/pre", b"pre-bytes")

    primary.attach_follower(standby_addr)

    # acked writes AFTER attach — must arrive via synchronous shipping
    for i in range(30):
        with kv as txn:
            txn.set(f"post/{i}", str(i).encode())
    idx = meta.create_index("s1", "text", "text", {"cfg": True})
    seg = meta.create_segment(idx.id, Seq(5), 10, index_metadata={"kind": "text"})
    meta.commit_operation(
        ready_segments=[seg.id],
        deletions=[(idx.id, Seq(6), ["r1/"])],
        touched_indexes=[idx.id],
    )
    bus_seqs = [bus.publish("st", "p.0", f"m{i}".encode()) for i in range(5)]
    m = bus.next("st", "c1")
    bus.ack("st", "c1", m.seq)
    blob.put("segments/post", b"post-bytes" * 100)
    assert kv.compare_and_swap("lock/a", None, b"owner1")
    status = _repl(standby_addr, "status")
    assert status["follower"] and status["applied"] > 0

    # KILL the primary: no grace, in-flight work cancelled
    primary.server.stop(None).wait()
    for c in (kv, meta, bus, blob):
        c.close()

    # promote over the wire and point clients at the standby
    _repl(standby_addr, "promote")
    kv2 = RemoteDriver(standby_addr)
    meta2 = RemoteMetadataStore(standby_addr)
    bus2 = RemoteBus(standby_addr)
    blob2 = RemoteStorage(standby_addr)
    with kv2 as txn:
        assert txn.get("pre/a") == b"1"
        for i in range(30):
            assert txn.get(f"post/{i}") == str(i).encode()
    assert meta2.get_shard("s1").kbid == "kb1"
    ready = meta2.ready_segments(idx.id)
    assert [s.id for s in ready] == [seg.id]
    assert meta2.deletions_for_index(idx.id) == [("r1/", Seq(6))]
    scans = bus2.scan("st", after_seq=0)
    assert [x.payload for x in scans] == [b"m-pre"] + [f"m{i}".encode() for i in range(5)]
    assert bus2.ack_floor("st", "c1") == m.seq  # consumer state replicated
    assert blob2.get("segments/pre") == b"pre-bytes"
    assert blob2.get("segments/post") == b"post-bytes" * 100
    # CAS state replicated: the lock owner survives failover
    assert not kv2.compare_and_swap("lock/a", None, b"owner2")
    # the promoted standby is a normal primary: it takes new writes
    with kv2 as txn:
        txn.set("after-failover", b"yes")
    with kv2 as txn:
        assert txn.get("after-failover") == b"yes"
    for c in (kv2, meta2, bus2, blob2):
        c.close()


def test_kill_primary_mid_write_stream(pair):
    """A writer acks sequential increments while the primary dies under it:
    every increment the CLIENT saw acked is on the promoted standby."""
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    kv = RemoteDriver(primary_addr)
    kv._RETRIES = 1  # fail fast once the primary is gone
    kv._RETRY_SLEEP = 0.05
    acked = []
    go = threading.Event()

    def writer():
        go.set()
        for i in range(10_000):
            try:
                with kv as txn:
                    txn.set(f"ctr/{i}", str(i).encode())
            except Exception:
                return  # unacked: the kill landed mid-call
            acked.append(i)

    t = threading.Thread(target=writer)
    t.start()
    go.wait()
    while len(acked) < 25:  # let some writes through, then kill mid-stream
        pass
    primary.server.stop(None)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(acked) >= 25
    kv.close()

    _repl(standby_addr, "promote")
    kv2 = RemoteDriver(standby_addr)
    with kv2 as txn:
        for i in acked:  # ZERO acked-write loss
            assert txn.get(f"ctr/{i}") == str(i).encode(), i
    kv2.close()


def test_replication_gap_detaches_standby(pair, caplog):
    """A standby that misses an entry (simulated by bumping its applied
    cursor expectation) rejects the next apply; the primary detaches it
    loudly and keeps serving."""
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    kv = RemoteDriver(primary_addr)
    with kv as txn:
        txn.set("a", b"1")
    standby._applied += 5  # simulate divergence
    with kv as txn:
        txn.set("b", b"2")  # ship fails -> detach, write still acked
    assert primary._repl_fn is None
    with kv as txn:  # primary keeps serving unreplicated
        txn.set("c", b"3")
        assert txn.get("b") == b"2"
    # a detached standby can re-bootstrap and catch up fully
    primary.attach_follower(standby_addr)
    with kv as txn:
        txn.set("d", b"4")
    primary.server.stop(None).wait()
    kv.close()
    _repl(standby_addr, "promote")
    kv2 = RemoteDriver(standby_addr)
    with kv2 as txn:
        assert [txn.get(k) for k in "abcd"] == [b"1", b"2", b"3", b"4"]
    kv2.close()


def test_snapshot_guard_and_empty_promote(tmp_path):
    s = SubstrateServer(str(tmp_path / "f"), follower=True)
    with pytest.raises(ValueError, match="no state"):
        s.snapshot(str(tmp_path / "snap"))
    s.promote()  # never bootstrapped: promotes to an empty substrate
    assert s._targets and not s.follower


# ---------------------------------------------------------------------------
# Automatic failover (r4): watch_primary self-promotion, ha_fence split-brain
# guard, client endpoint rotation. Together these replace the "operator
# promotes + repoints" step with an unattended failover pair — the posture
# managed PG gives the reference (nidx/src/metadata.rs:37-100).
# ---------------------------------------------------------------------------


def _wait_until(pred, timeout=10.0, step=0.02):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def test_standby_auto_promotes_when_primary_dies(pair):
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    kv = RemoteDriver(primary_addr)
    with kv as txn:
        txn.set("k", b"v")
    kv.close()
    standby.watch_primary(primary_addr, interval=0.1, misses=3)
    assert _wait_until(lambda: standby.watch_armed), "watcher never armed"
    assert standby.follower  # probes succeed while the primary lives
    primary.server.stop(None).wait()
    assert _wait_until(lambda: not standby.follower), "standby never promoted"
    kv2 = RemoteDriver(standby_addr)
    with kv2 as txn:
        assert txn.get("k") == b"v"
        txn.set("k2", b"v2")  # serves writes as a normal primary
    kv2.close()


def test_watch_primary_requires_follower(tmp_path):
    s = SubstrateServer(str(tmp_path / "p"))
    s.start()
    try:
        with pytest.raises(ValueError, match="unpromoted standbys"):
            s.watch_primary("127.0.0.1:1")
    finally:
        s.stop(0)


def test_ha_fence_blocks_writes_after_standby_loss(tmp_path):
    """Consistency-first mode: when the synchronous ship fails, the primary
    FENCES itself — the failing mutation and every later mutation are
    refused, reads keep serving, and re-attaching a standby lifts the
    fence. With the fence on, a promoted standby can never coexist with a
    writable old primary (no split-brain)."""
    primary = SubstrateServer(str(tmp_path / "primary"), ha_fence=True)
    primary.start()
    standby = SubstrateServer(str(tmp_path / "standby"), follower=True)
    standby.start()
    primary_addr = f"127.0.0.1:{primary.port}"
    primary.attach_follower(f"127.0.0.1:{standby.port}")

    kv = RemoteDriver(primary_addr)
    with kv as txn:
        txn.set("a", b"1")
    standby.server.stop(None).wait()  # standby dies
    with pytest.raises(RuntimeError, match="primary fenced"):
        with kv as txn:
            txn.set("b", b"2")  # ship fails -> fence; THIS op is refused
    assert primary._fenced
    with pytest.raises(RuntimeError, match="primary fenced"):
        with kv as txn:
            txn.set("c", b"3")  # every later mutation refused too
    with kv as txn:  # reads still serve (read-only plane is not fenced)
        assert txn.get("a") == b"1"

    # the refused write must leave NO local trace: the ship-first protocol
    # refuses BEFORE executing, so the primary's state is exactly the acked
    # prefix (an executed-then-refused write would resurrect through the
    # next attach_follower snapshot)
    with kv as txn:
        assert txn.get("b") is None
        assert txn.get("c") is None

    # re-attaching a (new) standby lifts the fence; bootstrap carries the
    # pre-fence state, NOT the refused writes
    standby2 = SubstrateServer(str(tmp_path / "standby2"), follower=True)
    standby2.start()
    primary.attach_follower(f"127.0.0.1:{standby2.port}")
    assert not primary._fenced
    with kv as txn:
        txn.set("d", b"4")
    kv.close()
    _repl(f"127.0.0.1:{standby2.port}", "status")
    primary.stop(0)
    standby2.promote()
    kv2 = RemoteDriver(f"127.0.0.1:{standby2.port}")
    with kv2 as txn:
        assert txn.get("a") == b"1"
        assert txn.get("d") == b"4"
        # the refused writes never resurrected into the new pair either
        assert txn.get("b") is None
        assert txn.get("c") is None
    kv2.close()
    standby2.stop(0)


def test_op_level_error_is_consistent_across_pair(pair):
    """Ship-first means deterministically-failing ops reach the standby:
    it consumes the entry (no gap), reports op_err, and the primary's own
    execution raises the same error to the client — neither side changes
    state and replication stays attached."""
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    kv = RemoteDriver(primary_addr)
    with pytest.raises(ValueError, match="bad kv op"):
        kv._call("apply", [("bogus", "k")])  # deterministic op error, both sides
    assert primary._repl_fn is not None, "op-level error must not detach"
    with kv as txn:  # the stream is gap-free: later ops still replicate
        txn.set("after-op-err", b"1")
    assert standby._applied >= 2  # failing entry + the set both consumed
    kv.close()
    _repl(standby_addr, "promote")
    kv2 = RemoteDriver(standby_addr)
    with kv2 as txn:
        assert txn.get("after-op-err") == b"1"
    kv2.close()


def test_dirty_node_refuses_to_seed_standby(pair):
    """A node whose pair DIVERGED (standby rejected an op it applied) is
    dirty: attach_follower from it must refuse — snapshotting its state
    would resurrect the divergent write into the new pair."""
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    primary._dirty = True  # as _divergence() would set
    standby2_addr = standby_addr  # any address: refusal happens first
    with pytest.raises(RuntimeError, match="dirty"):
        primary.attach_follower(standby2_addr)


def test_attach_during_concurrent_unreplicated_writes(pair):
    """Fast-path mutations (no standby attached) run without the
    replication lock; attach_follower must drain them before snapshotting
    so every acked write lands in snapshot+stream exactly once."""
    primary, primary_addr, standby, standby_addr = pair
    kv = RemoteDriver(primary_addr)
    acked = []
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            with kv as txn:
                txn.set(f"w/{i}", str(i).encode())
            acked.append(i)
            i += 1

    t = threading.Thread(target=writer)
    t.start()
    while len(acked) < 10:
        pass
    primary.attach_follower(standby_addr)  # drains + snapshots mid-stream
    while len(acked) < 30:
        pass
    stop.set()
    t.join(timeout=30)
    kv.close()
    primary.server.stop(None).wait()
    _repl(standby_addr, "promote")
    kv2 = RemoteDriver(standby_addr)
    with kv2 as txn:
        for i in acked:
            assert txn.get(f"w/{i}") == str(i).encode(), i
    kv2.close()


def test_client_endpoint_rotation_follows_failover(pair):
    """A Remote client configured with BOTH endpoints rides through a
    primary death + standby auto-promotion with no operator action and no
    acked-write loss: UNAVAILABLE and 'standby not promoted' both rotate
    to the next endpoint until the promotion lands."""
    primary, primary_addr, standby, standby_addr = pair
    primary.attach_follower(standby_addr)
    standby.watch_primary(primary_addr, interval=0.1, misses=2)
    assert _wait_until(lambda: standby.watch_armed), "watcher never armed"

    kv = RemoteDriver(f"{primary_addr},{standby_addr}")
    kv._RETRY_SLEEP = 0.05
    for i in range(10):
        with kv as txn:
            txn.set(f"k/{i}", str(i).encode())
    primary.server.stop(None).wait()
    # the SAME client object keeps working: rotation finds the standby,
    # retries through its promotion window, then sticks
    with kv as txn:
        for i in range(10):
            assert txn.get(f"k/{i}") == str(i).encode()
        txn.set("post-failover", b"yes")
    assert not standby.follower
    with kv as txn:
        assert txn.get("post-failover") == b"yes"
    kv.close()


def test_ha_fence_boots_fenced_until_standby_attaches(tmp_path):
    """An ha_fence primary refuses mutations from start() until the standby
    attaches — writes slipped in between would be acked-but-unreplicated,
    the exact loss the fence exists to rule out (caught live: a client
    racing the boot sequence acked 20 writes the standby never saw)."""
    primary = SubstrateServer(str(tmp_path / "primary"), ha_fence=True)
    primary.start()
    kv = RemoteDriver(f"127.0.0.1:{primary.port}")
    with pytest.raises(RuntimeError, match="primary fenced"):
        with kv as txn:
            txn.set("early", b"lost")
    standby = SubstrateServer(str(tmp_path / "standby"), follower=True)
    standby.start()
    primary.attach_follower(f"127.0.0.1:{standby.port}")
    with kv as txn:  # attach lifts the boot fence
        txn.set("a", b"1")
    assert standby._applied == 1
    kv.close()
    primary.stop(0)
    standby.stop(0)


def test_watcher_not_armed_until_primary_seen_alive(tmp_path):
    """A standby watching a primary that has never been reachable must NOT
    self-promote (caught live: a standby booted before its primary promoted
    an empty substrate over the healthy pair). Once the primary has been
    seen alive, the same watcher does promote on its death; promote() lifts
    any fence so the survivor serves."""
    standby = SubstrateServer(str(tmp_path / "standby"), follower=True,
                              ha_fence=True)
    standby.start()
    standby.watch_primary("127.0.0.1:19199", interval=0.05, misses=2)
    import time

    time.sleep(0.5)  # >> misses*interval with no primary ever alive
    assert standby.follower, "watcher promoted without ever seeing the primary"

    primary = SubstrateServer(str(tmp_path / "primary"),
                              address="127.0.0.1:19199")
    primary.start()
    primary.attach_follower(f"127.0.0.1:{standby.port}")
    kv = RemoteDriver("127.0.0.1:19199")
    with kv as txn:
        txn.set("k", b"v")
    kv.close()
    assert _wait_until(lambda: standby.watch_armed), "watcher never armed"
    assert standby.follower  # probes succeeding: still follower
    primary.server.stop(None).wait()
    primary.stop(0)
    assert _wait_until(lambda: not standby.follower), \
        "armed watcher never promoted after primary death"
    kv2 = RemoteDriver(f"127.0.0.1:{standby.port}")
    with kv2 as txn:  # promoted + unfenced: serves writes
        assert txn.get("k") == b"v"
        txn.set("k2", b"v2")
    kv2.close()
    standby.stop(0)


def test_failover_during_indexer_ingest(tmp_path):
    """Kill the primary mid-INGEST (segment blob uploads + metadata commits
    shipping synchronously): every resource the indexer saw ACKED is fully
    present on the promoted standby — segments queryable, blobs readable
    (VERDICT r4 task 8's kill-primary-mid-ingest guarantee)."""
    import numpy as np

    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.models.internal import (
        IndexParagraph,
        ResourceDoc,
        TextInformation,
        VectorSentence,
    )
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.substrate import RemoteMetadataStore, RemoteStorage

    primary = SubstrateServer(str(tmp_path / "primary"))
    primary.start()
    standby = SubstrateServer(str(tmp_path / "standby"), follower=True)
    standby.start()
    primary.attach_follower(f"127.0.0.1:{standby.port}")
    addrs = f"127.0.0.1:{primary.port},127.0.0.1:{standby.port}"

    meta = RemoteMetadataStore(addrs)
    blob = RemoteStorage(addrs)
    meta._RETRIES = blob._RETRIES = 1
    meta._RETRY_SLEEP = blob._RETRY_SLEEP = 0.05
    node = EmbeddedNode(
        data_dir=str(tmp_path / "node"), metadata=meta, storage=blob, device="cpu"
    )
    dim = 16
    shard_id = node.create_shard("kb", {"m": VectorConfig(dimension=dim)})
    rng = np.random.default_rng(1)

    def make_res(i: int) -> ResourceDoc:
        rid = f"res{i:04d}"
        rd = ResourceDoc(resource_id=rid, created=1.0 + i, modified=1.0 + i)
        rd.texts["t/t1"] = TextInformation(text=f"hello world doc {i}")
        para = IndexParagraph(start=0, end=10)
        v = rng.standard_normal(dim).astype(np.float32)
        para.vectorsets_sentences["m"] = {
            f"{rid}/t/t1/0/0-10": VectorSentence(vector=v)
        }
        rd.paragraphs["t/t1"] = {f"{rid}/t/t1/0-10": para}
        return rd

    acked = []
    killer = {"done": False}

    def kill_after(n: int):
        while len(acked) < n:
            pass
        primary.server.stop(None)
        killer["done"] = True

    t = threading.Thread(target=kill_after, args=(6,))
    t.start()
    for i in range(200):
        try:
            node.index(shard_id, make_res(i))
        except Exception:
            break  # unacked: the kill landed mid-call
        acked.append(i)
    t.join(timeout=30)
    assert killer["done"] and len(acked) >= 6

    standby.promote()
    # the SAME clients rotate to the promoted standby
    indexes = meta.get_indexes(shard_id)
    assert indexes, "shard metadata lost"
    assert any(meta.ready_segments(idx.id) for idx in indexes)

    # end-to-end: a FRESH node over the promoted standby must serve every
    # acked resource (segments committed AND blobs shipped before the ack)
    from nucliadb_tpu_torch.shard.searcher import ShardSearchRequest

    node2 = EmbeddedNode(
        device="cpu",
        data_dir=str(tmp_path / "node2"),
        metadata=RemoteMetadataStore(f"127.0.0.1:{standby.port}"),
        storage=RemoteStorage(f"127.0.0.1:{standby.port}"),
    )
    node2.wait_for_sync()
    resp = node2.search(
        shard_id,
        ShardSearchRequest(body="hello", top_k=500, paragraph=True),
    )
    got_rids = {h.rid for h in resp.paragraph.hits}
    acked_rids = {f"res{i:04d}" for i in acked}
    assert acked_rids <= got_rids, acked_rids - got_rids
    primary.stop(0)
    standby.stop(0)

"""The scenarios of ``tests/test_infra.py`` on the port: the port's bus,
tasks, audit, back pressure, export/import, rollover and utilities, with
every node on the CPU (``device="cpu"``).
"""

import time

import numpy as np
import pytest

from nucliadb_tpu_torch.bus import EmbeddedBus
from nucliadb_tpu_torch.common.audit import AuditStream, AuditType, AUDIT_STREAM
from nucliadb_tpu_torch.common.back_pressure import (
    BackPressureMaterializer,
    BackPressureSettings,
    TryAfterError,
)
from nucliadb_tpu_torch.common.export_import import (
    create_backup,
    export_kb,
    import_kb,
    list_backups,
    restore_backup,
)
from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
from nucliadb_tpu_torch.common.rollover import rebalance_kb, rollover_kb
from nucliadb_tpu_torch.ingest.processor import Processor
from nucliadb_tpu_torch.maindb import Driver
from nucliadb_tpu_torch.metadata import MetadataStore
from nucliadb_tpu_torch.models.api import (
    CreateResourcePayload,
    FindRequest,
    KnowledgeBoxConfig,
    SearchFeature,
    TextFieldPayload,
    VectorSetSpec,
)
from nucliadb_tpu_torch.search import SearchService
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.storage import MemoryStorage
from nucliadb_tpu_torch.tasks import TaskConsumer, TaskProducer


# ---- bus -------------------------------------------------------------------


def test_bus_ordering_and_ack():
    bus = EmbeddedBus()
    for i in range(3):
        bus.publish("s1", "sub.a", f"m{i}".encode())
    m1 = bus.next("s1", "c1")
    assert m1.payload == b"m0" and m1.deliveries == 1
    bus.ack("s1", "c1", m1.seq)
    m2 = bus.next("s1", "c1")
    assert m2.payload == b"m1"
    # unacked m2 is leased: next returns the following message only after lease
    bus.ack("s1", "c1", m2.seq)
    assert bus.next("s1", "c1").payload == b"m2"


def test_bus_redelivery_and_poison():
    bus = EmbeddedBus(ack_wait=0.01)
    bus.publish("s1", "sub", b"bad")
    bus.publish("s1", "sub", b"good")
    seen = 0
    while True:
        msg = bus.next("s1", "c1")
        if msg is None or msg.payload == b"good":
            break
        seen += 1
        time.sleep(0.02)  # let the lease expire, never ack
    assert seen == 5  # MAX_DELIVERIES, then skipped
    assert msg is not None and msg.payload == b"good"


def test_bus_pending_and_floor():
    bus = EmbeddedBus()
    for i in range(5):
        bus.publish("s1", "x", b"p")
    assert bus.pending("s1", "c") == 5
    m = bus.next("s1", "c")
    bus.ack("s1", "c", m.seq)
    assert bus.ack_floor("s1", "c") == 1
    assert bus.pending("s1", "c") == 4


def test_bus_subject_filter_and_watch():
    bus = EmbeddedBus()
    events = []
    bus.watch("s1", lambda m: events.append(m.subject))
    bus.publish("s1", "a.1", b"x")
    bus.publish("s1", "b.1", b"y")
    assert events == ["a.1", "b.1"]
    m = bus.next("s1", "c", subject_prefix="b.")
    assert m.subject == "b.1"


def test_tasks_framework():
    bus = EmbeddedBus()
    done = []
    producer = TaskProducer(bus, "reindex")
    consumer = TaskConsumer(bus, "reindex", lambda t: done.append((t.kbid, t.payload)))
    producer.send("kb1", rid="r1")
    producer.send("kb2", rid="r2")
    assert consumer.drain() == 2
    assert done == [("kb1", {"rid": "r1"}), ("kb2", {"rid": "r2"})]


def test_tasks_retry_then_dead_letter():
    from nucliadb_tpu_torch.bus.stream import MAX_DELIVERIES
    from nucliadb_tpu_torch.tasks import create_consumer, create_producer

    bus = EmbeddedBus(ack_wait=0.0)  # expired lease -> immediate redelivery
    attempts = []

    def boom(task):
        attempts.append(task.kbid)
        raise RuntimeError("poison")

    producer = create_producer(bus, "reindex")
    consumer = create_consumer(bus, "reindex", boom)
    producer.send("kbp", rid="r1")
    for _ in range(MAX_DELIVERIES + 2):
        consumer.work_once()
    # retried exactly MAX_DELIVERIES times, then dead-lettered + acked
    assert attempts == ["kbp"] * MAX_DELIVERIES
    dlq = consumer.dead_letters()
    assert len(dlq) == 1 and dlq[0].kbid == "kbp" and dlq[0].payload == {"rid": "r1"}
    # stream keeps moving: a healthy task after the poison one still runs
    ok = []
    consumer2 = create_consumer(
        bus, "reindex", lambda t: ok.append(t.kbid)
    )
    # reuse same durable consumer name: already past the poison message
    consumer2.consumer = consumer.consumer
    producer.send("kbq", rid="r2")
    assert consumer2.drain() == 1
    assert ok == ["kbq"]


def test_task_producer_validates():
    import pytest

    from nucliadb_tpu_torch.tasks import create_producer

    bus = EmbeddedBus()
    producer = create_producer(bus, "validated")
    with pytest.raises(ValueError):
        producer.send("", rid="r1")


def test_audit_stream():
    bus = EmbeddedBus()
    audit = AuditStream(bus)
    audit.search("kb1", "hello", 3)
    msg = bus.next(AUDIT_STREAM, "auditor")
    assert msg is not None and b"hello" in msg.payload


# ---- back pressure -----------------------------------------------------------


def test_back_pressure(tmp_path):
    meta = MetadataStore(str(tmp_path / "m.db"))
    bp = BackPressureMaterializer(
        meta, settings=BackPressureSettings(max_indexing_pending=2)
    )
    bp.check_indexing()  # empty: fine
    for _ in range(4):
        meta.record_index_request(meta.next_seq())
    with pytest.raises(TryAfterError) as e:
        bp.check_indexing()
    assert e.value.try_after > 0


def test_back_pressure_merge_debt(tmp_path):
    """Sustained ingest that outpaces merging must 429 before the
    searcher's per-segment memmaps exhaust the process fd budget (caught
    live by the 15-minute soak: EMFILE at ~20k fds) — the unmerged-
    segment throttle trips on total READY segments."""
    meta = MetadataStore(str(tmp_path / "m2.db"))
    bp = BackPressureMaterializer(
        meta, settings=BackPressureSettings(max_ready_segments=3)
    )
    meta.create_shard("s", "kb")
    idx = meta.create_index("s", "text", "text", {})
    rows = meta.create_segments([
        {"index_id": idx.id, "seq": i + 1, "records": 1} for i in range(5)
    ])
    bp.check_indexing()  # created but not ready: below the bar
    meta.commit_operation(
        ready_segments=[r.id for r in rows], deletions=[], touched_indexes=[]
    )
    bp._seg_count_cache = None
    with pytest.raises(TryAfterError, match="unmerged segments"):
        bp.check_indexing()
    # merging (dropping segments) releases the throttle
    for r in rows[:3]:
        meta.drop_segment(r.id)
    bp._seg_count_cache = None
    bp.check_indexing()


# ---- export/import/backup/rollover -------------------------------------------


def make_stack(tmp_path, name):
    node = EmbeddedNode(data_dir=str(tmp_path / name), storage=MemoryStorage(), device="cpu")
    driver = Driver(str(tmp_path / f"{name}.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    search = SearchService(node, kbs, processor)
    return node, kbs, processor, search


def populate(kbs, processor, n=4):
    kbid = kbs.create(KnowledgeBoxConfig(slug="src", vectorsets={}))
    for i in range(n):
        processor.create_resource(
            kbid,
            CreateResourcePayload(
                title=f"Doc {i}",
                texts={
                    "t": TextFieldPayload(
                        body=f"document number {i} about {'alpha' if i % 2 else 'omega'}"
                    )
                },
            ),
        )
    return kbid


def test_export_import_roundtrip(tmp_path):
    node, kbs, processor, search = make_stack(tmp_path, "a")
    kbid = populate(kbs, processor)
    blob = export_kb(kbs, processor, kbid)

    node2, kbs2, processor2, search2 = make_stack(tmp_path, "b")
    new_kbid = import_kb(kbs2, processor2, blob, slug="imported")
    assert len(processor2.list_resources(new_kbid)) == 4
    node2.wait_for_sync()
    res = search2.find(
        new_kbid, FindRequest(query="alpha", features=[SearchFeature.KEYWORD])
    )
    assert len(res.resources) == 2


def test_backup_restore(tmp_path):
    node, kbs, processor, search = make_stack(tmp_path, "c")
    kbid = populate(kbs, processor)
    storage = MemoryStorage()
    backup_id = create_backup(kbs, processor, storage, kbid)
    assert backup_id in list_backups(storage)
    restored = restore_backup(kbs, processor, storage, backup_id, slug="restored")
    assert restored != kbid
    assert len(processor.list_resources(restored)) == 4


def test_rollover(tmp_path):
    node, kbs, processor, search = make_stack(tmp_path, "d")
    kbid = populate(kbs, processor, n=5)
    node.wait_for_sync()
    old = kbs.get_shards(kbid).shards
    new_shards = rollover_kb(kbs, processor, node, kbid, n_shards=2)
    assert len(new_shards) == 2 and set(new_shards) != set(old)
    node.wait_for_sync()
    res = search.find(kbid, FindRequest(query="document", features=[SearchFeature.KEYWORD]))
    assert len(res.resources) == 5
    # resource metas updated to new shards
    for rid in processor.list_resources(kbid):
        assert processor.get_meta(kbid, rid).shard in new_shards


def test_rebalance(tmp_path):
    node, kbs, processor, search = make_stack(tmp_path, "e")
    kbid = kbs.create(KnowledgeBoxConfig(slug="reb", shards=2))
    for i in range(6):
        processor.create_resource(
            kbid,
            CreateResourcePayload(title=f"D{i}", texts={"t": TextFieldPayload(body=f"doc {i}")}),
        )
    # all went to shard 0 (writable); rebalance should spread them
    counts = rebalance_kb(kbs, processor, node, kbid)
    assert len(counts) == 2
    assert max(counts.values()) - min(counts.values()) <= 2
    node.wait_for_sync()
    res = search.find(kbid, FindRequest(query="doc", features=[SearchFeature.KEYWORD]))
    assert len(res.resources) == 6


def test_extract_text_formats():
    from nucliadb_tpu_torch.ingest.extract import extract_text, sniff_content_type

    assert extract_text("a.txt", "text/plain", b"hello world") == "hello world"
    assert "title" not in (
        extract_text("a.html", "", b"<html><style>p{}</style><p>Only this</p></html>") or ""
    )
    assert extract_text("a.html", "", b"<p>Only this</p>") == "Only this"
    assert extract_text("d.json", "", b'{"a": ["x", {"b": "y"}], "n": 3}') == "x\ny"
    assert extract_text("blob.bin", "application/octet-stream", b"\x00\x01") is None
    assert sniff_content_type("f.md", "application/octet-stream") == "text/markdown"
    assert sniff_content_type("f", "text/html; charset=utf-8") == "text/html"


def test_utilization_tracker():
    import time as _time

    from nucliadb_tpu_torch.telemetry.metrics import UtilizationTracker

    t = UtilizationTracker("testcomp")
    _time.sleep(0.02)
    with t.work():
        _time.sleep(0.03)
    busy, idle = t.totals()
    assert busy >= 0.025 and idle >= 0.015


def test_warmup_kernels():
    """The port's warm-up takes a device, not the JAX package's dims: it
    builds and loads the hand kernels on a card (``kernels._loaded`` keeps
    them, so a second call builds nothing) and runs the hot programs once.
    On the CPU it loads no kernel and runs the plain versions. A device is
    warmed once a process: the second call returns at once and dispatches
    no BM25 program, as the JAX package's second call finds its jit cache."""
    from nucliadb_tpu_torch.ops import bm25
    from nucliadb_tpu_torch.utils import kernels
    from nucliadb_tpu_torch.utils.warmup import warmup_kernels

    loaded = dict(kernels._loaded)
    assert warmup_kernels("cpu") >= 0.0
    dispatches = dict(bm25.DISPATCHES)
    # second call is cached (near-instant)
    assert warmup_kernels("cpu") < 1.0
    assert kernels._loaded == loaded
    assert dict(bm25.DISPATCHES) == dispatches


def test_keyed_lock_exclusion_and_pruning():
    import threading
    import time as _time

    from nucliadb_tpu_torch.common.locking import KeyedLock

    kl = KeyedLock()
    order = []

    def hold(tag, wait):
        with kl.hold("k"):
            order.append(f"{tag}-in")
            _time.sleep(wait)
            order.append(f"{tag}-out")

    t1 = threading.Thread(target=hold, args=("a", 0.05))
    t2 = threading.Thread(target=hold, args=("b", 0.0))
    t1.start(); _time.sleep(0.01); t2.start()
    t1.join(); t2.join()
    assert order == ["a-in", "a-out", "b-in", "b-out"]  # b waited for a
    assert kl._locks == {}  # idle entries pruned

    # different keys don't contend
    got = []
    with kl.hold("x"):
        t = threading.Thread(target=lambda: (kl.hold("y").__enter__(), got.append(1)))
        t.start(); t.join(timeout=1)
    assert got == [1]


def test_encryption_util_and_learning_secrets(tmp_path):
    """Secrets encrypt at rest when a key is configured (parity:
    nucliadb_utils encryption + learning config secret fields)."""
    from nucliadb_tpu_torch.learning_proxy import LEARNING_KEY, LearningProxy
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.utils.encryption import Endecryptor

    key = Endecryptor.generate_key()
    enc = Endecryptor(key)
    assert enc.active
    token = enc.encrypt("s3cret")
    assert token != "s3cret" and token.startswith("enc::")
    assert enc.decrypt(token) == "s3cret"
    # no key -> documented passthrough
    noop = Endecryptor("")
    assert not noop.active and noop.encrypt("x") == "x"

    driver = Driver(str(tmp_path / "kv.db"))
    proxy = LearningProxy(driver, endecryptor=enc)
    secret = "plaintext-credential-123"
    out = proxy.set_configuration("kb1", {"semantic_model": "m", "api_key": secret})
    assert out["api_key"] == secret  # callers see plaintext
    with driver as txn:
        raw = txn.get(LEARNING_KEY.format(kbid="kb1")).decode()
    assert secret not in raw and "enc::" in raw  # at rest: ciphertext
    assert proxy.get_configuration("kb1")["api_key"] == secret


def test_scheduler_kb_storage_audit(tmp_path):
    """The scheduler tick ships per-KB storage reports to the audit stream
    (parity: nidx scheduler audit_task.rs)."""
    import json as _json

    import numpy as np

    from nucliadb_tpu_torch.common.audit import AUDIT_STREAM, AuditStream
    from nucliadb_tpu_torch.index.vector import VectorConfig
    from nucliadb_tpu_torch.models.internal import IndexParagraph, ResourceDoc, TextInformation, VectorSentence
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.storage import MemoryStorage

    node = EmbeddedNode(data_dir=str(tmp_path / "n"), storage=MemoryStorage(), device="cpu")
    bus = EmbeddedBus()
    node.scheduler.audit = AuditStream(bus)
    shard = node.create_shard("kbaud", {"m1": VectorConfig(dimension=8)})
    rd = ResourceDoc(resource_id="r1", created=1, modified=1)
    rd.texts["t/t"] = TextInformation(text="storage audit doc")
    p = IndexParagraph(start=0, end=17)
    p.vectorsets_sentences["m1"] = {"r1/t/t/0/0-17": VectorSentence(vector=np.ones(8, np.float32))}
    rd.paragraphs["t/t"] = {"r1/t/t/0-17": p}
    node.index(shard, rd)
    node.wait_for_sync()

    report = node.scheduler.audit_storage()
    assert report["kbaud"]["segments"] >= 1 and report["kbaud"]["bytes"] > 0
    events = [
        _json.loads(m.payload)
        for m in bus.scan(AUDIT_STREAM, subject_prefix="audit.kbaud")
    ]
    assert any(e["type"] == "storage" and e["detail"]["bytes"] > 0 for e in events)


def test_rollover_with_concurrent_writes(tmp_path):
    """Writes racing the rollover window must survive the shard swap (the
    straggler-repair passes in rollover_kb; parity intent: the reference's
    rollover indexes resources modified during the rollover before cutover,
    common/cluster/rollover.py)."""
    import threading

    node, kbs, processor, search = make_stack(tmp_path, "rollrace")
    kbid = populate(kbs, processor, n=8)
    node.wait_for_sync()

    stop = threading.Event()
    written: list[str] = []
    errors: list[BaseException] = []

    def writer():
        i = 0
        while not stop.is_set():
            try:
                rid, _ = processor.create_resource(
                    kbid,
                    CreateResourcePayload(
                        title=f"race{i}",
                        texts={"t": TextFieldPayload(body=f"racing document {i}")},
                    ),
                )
                written.append(rid)
                i += 1
            except BaseException as e:  # pragma: no cover - surfaced below
                errors.append(e)
                return

    t = threading.Thread(target=writer)
    t.start()
    try:
        new_shards = rollover_kb(kbs, processor, node, kbid, n_shards=2)
    finally:
        stop.set()
        t.join(10)
    assert not errors, errors
    assert written, "writer thread should have landed at least one resource"

    node.wait_for_sync()
    # every racing write is searchable and owned by a live (new) shard
    res = search.find(
        kbid, FindRequest(query="racing document", features=[SearchFeature.KEYWORD], top_k=100)
    )
    missing = [rid for rid in written if rid not in res.resources]
    assert not missing, f"lost {len(missing)}/{len(written)} racing writes"
    for rid in processor.list_resources(kbid):
        assert processor.get_meta(kbid, rid).shard in new_shards


def test_key_prefix_ranges_astral_plane():
    """Regression: the U+FFFF sentinel upper bound excluded keys whose first
    character after the prefix is an astral-plane code point (> U+FFFF), so
    deletion masks / prefilters missed e.g. emoji-named fields."""
    from nucliadb_tpu_torch.utils.keys import key_matches_prefix, key_prefix_ranges

    emoji_key = "rid/t/\U0001f600notes/0-10"
    keys = sorted([emoji_key, "rid/t/plain/0-5", "rid/t", "rid/t0/x", "rid/tz"])

    def matched(prefixes):
        got = set()
        for lo, hi in key_prefix_ranges(keys, prefixes):
            got.update(keys[lo:hi])
        return got

    got = matched(["rid/t"])
    assert got == {k for k in keys if key_matches_prefix(k, "rid/t")}
    assert emoji_key in got and "rid/t0/x" not in got and "rid/tz" not in got

    got_slash = matched(["rid/t/"])
    assert emoji_key in got_slash and "rid/t" not in got_slash
    assert "rid/t0/x" not in got_slash


def test_driver_with_block_is_reentrant_and_threadsafe(tmp_path):
    """Regression: Driver.__enter__ stored the txn on a shared attribute —
    a nested or cross-thread `with driver` committed the other block's
    buffer and could leak the outer lock acquisition."""
    import threading

    from nucliadb_tpu_torch.maindb import Driver

    driver = Driver(str(tmp_path / "kv.db"))
    with driver as outer:
        outer.set("/outer", b"1")
        with driver as inner:
            inner.set("/inner", b"2")
        outer.set("/outer2", b"3")
    with driver as txn:
        assert txn.get("/outer") == b"1"
        assert txn.get("/inner") == b"2"
        assert txn.get("/outer2") == b"3"

    # outer abort rolls back INNER commits too (savepoint semantics): a
    # plain conn.commit() from the inner block used to flush outer writes
    try:
        with driver as outer:
            outer.set("/atomic-outer", b"1")
            with driver as inner:
                inner.set("/atomic-inner", b"2")
            raise RuntimeError("outer fails after inner commit")
    except RuntimeError:
        pass
    with driver as txn:
        assert txn.get("/atomic-outer") is None
        assert txn.get("/atomic-inner") is None

    # no lock leak: other threads still get transactions
    ok = []

    def worker():
        with driver as t:
            t.set("/t", b"4")
        ok.append(True)

    t = threading.Thread(target=worker)
    t.start()
    t.join(5)
    assert ok == [True]


def test_learning_config_concurrent_updates_not_lost(tmp_path):
    """Regression: set_configuration did read-modify-write across two
    transactions; concurrent PATCHes silently erased each other's fields."""
    import threading

    from nucliadb_tpu_torch.learning_proxy import LearningProxy
    from nucliadb_tpu_torch.maindb import Driver

    proxy = LearningProxy(Driver(str(tmp_path / "kv.db")))
    barrier = threading.Barrier(2)

    def patch(field):
        barrier.wait()
        for i in range(25):
            proxy.set_configuration("kb1", {field: f"{field}-{i}"})

    ts = [threading.Thread(target=patch, args=(f,)) for f in ("alpha", "beta")]
    [t.start() for t in ts]
    [t.join(30) for t in ts]
    cfg = proxy.get_configuration("kb1")
    assert cfg.get("alpha") == "alpha-24" and cfg.get("beta") == "beta-24", cfg

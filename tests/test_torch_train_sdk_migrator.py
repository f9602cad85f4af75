"""The scenarios of ``tests/test_train_sdk_migrator.py`` on the port: the port's
trainset generators, migrator, SDK (against the port's ``StandaloneApp`` on
the CPU) and ops tool (``--device cpu``).
"""

import asyncio
import threading

import pytest

from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
from nucliadb_tpu_torch.ingest.processor import Processor
from nucliadb_tpu_torch.maindb import Driver
from nucliadb_tpu_torch.migrator import (
    Migration,
    MigrationContext,
    current_version,
    register,
    registered,
    run_migrations,
    _REGISTRY,
)
from nucliadb_tpu_torch.models.api import (
    AskRequest,
    Classification,
    CreateResourcePayload,
    KnowledgeBoxConfig,
    RelationNodePayload,
    RelationPayload,
    TextFieldPayload,
    UserMetadata,
)
from nucliadb_tpu_torch.services import EmbeddedNode
from nucliadb_tpu_torch.storage import MemoryStorage
from nucliadb_tpu_torch.train import (
    TrainSet,
    export_trainset,
    field_classification_batches,
    paragraph_classification_batches,
    qa_batches,
    sentence_batches,
    token_classification_batches,
)
from nucliadb_tpu_torch.train.dataset import load_partition


@pytest.fixture
def stack(tmp_path):
    node = EmbeddedNode(data_dir=str(tmp_path / "node"), storage=MemoryStorage(), device="cpu")
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    kbid = kbs.create(KnowledgeBoxConfig(slug="train"))
    p1 = CreateResourcePayload(
        title="What is a fox?",
        texts={"t": TextFieldPayload(body="The fox is quick.\n\nIt hunts at night.")},
        usermetadata=UserMetadata(
            classifications=[Classification(labelset="topic", label="animals")]
        ),
    )
    p1.usergenerated_relations = [
        RelationPayload(
            relation="ENTITY",
            **{"from": RelationNodePayload(value="fox", group="ANIMAL")},
            to=RelationNodePayload(value="night", group="TIME"),
        )
    ]
    processor.create_resource(kbid, p1)
    processor.create_resource(
        kbid,
        CreateResourcePayload(
            title="Market news",
            texts={"t": TextFieldPayload(body="Stocks rallied.")},
            usermetadata=UserMetadata(
                classifications=[Classification(labelset="topic", label="finance")]
            ),
        ),
    )
    return node, driver, kbs, processor, kbid


def test_paragraph_classification(stack):
    node, driver, kbs, processor, kbid = stack
    batches = list(paragraph_classification_batches(processor, TrainSet(kbid=kbid)))
    texts = [t for b in batches for t in b.texts]
    labels = [l for b in batches for l in b.labels]
    assert "The fox is quick." in texts
    assert ["/l/topic/animals"] in labels


def test_field_classification_and_sentences(stack):
    node, driver, kbs, processor, kbid = stack
    fb = list(field_classification_batches(processor, TrainSet(kbid=kbid)))
    assert any("/l/topic/finance" in l for b in fb for l in b.labels)
    sb = list(sentence_batches(processor, TrainSet(kbid=kbid, batch_size=2)))
    assert sum(len(b.texts) for b in sb) >= 4


def test_token_classification(stack):
    node, driver, kbs, processor, kbid = stack
    batches = list(token_classification_batches(processor, TrainSet(kbid=kbid)))
    found = False
    for b in batches:
        for tokens, tags in zip(b.tokens, b.tags):
            if "fox" in tokens:
                assert tags[tokens.index("fox")] == "B-ANIMAL"
                found = True
    assert found


def test_qa_batches(stack):
    node, driver, kbs, processor, kbid = stack
    batches = list(qa_batches(processor, TrainSet(kbid=kbid)))
    qs = [q for b in batches for q in b.questions]
    assert "What is a fox?" in qs


def test_export_trainset(stack, tmp_path):
    node, driver, kbs, processor, kbid = stack
    manifest = export_trainset(
        processor, TrainSet(kbid=kbid), "paragraph_classification", str(tmp_path / "ds")
    )
    assert manifest["examples"] >= 3
    assert manifest["format"] == "arrow"
    assert manifest["partitions"][0].endswith(".arrow")
    part = load_partition(str(tmp_path / "ds" / manifest["partitions"][0]))
    assert part[0]["texts"]
    assert isinstance(part[0]["labels"][0], list)

    # arrow partitions are plain IPC streams any arrow loader reads
    import pyarrow as pa

    with pa.OSFile(str(tmp_path / "ds" / manifest["partitions"][0]), "rb") as f:
        table = pa.ipc.open_stream(f).read_all()
    assert table.num_rows == manifest["examples"]
    assert set(table.schema.names) == {"texts", "labels"}


def test_export_trainset_msgpack(stack, tmp_path):
    node, driver, kbs, processor, kbid = stack
    manifest = export_trainset(
        processor,
        TrainSet(kbid=kbid),
        "sentences",
        str(tmp_path / "ds2"),
        format="msgpack",
    )
    assert manifest["partitions"][0].endswith(".msgpack")
    part = load_partition(str(tmp_path / "ds2" / manifest["partitions"][0]))
    assert part[0]["texts"]


def test_migrator(stack):
    node, driver, kbs, processor, kbid = stack
    saved = list(_REGISTRY)
    _REGISTRY.clear()
    calls = []
    register(
        Migration(version=1, name="noop-global", global_fn=lambda ctx: calls.append("g1"))
    )
    register(
        Migration(
            version=2, name="per-kb", kb_fn=lambda ctx, k: calls.append(("kb", k))
        )
    )
    ctx = MigrationContext(driver=driver, node=node, kbs=kbs, processor=processor)
    applied = run_migrations(ctx)
    assert applied == ["noop-global", "per-kb"]
    assert "g1" in calls and ("kb", kbid) in calls
    assert current_version(driver) == 2
    # second run: nothing to do
    assert run_migrations(ctx) == []
    _REGISTRY.clear()
    _REGISTRY.extend(saved)


def test_sdk_against_server(tmp_path):
    from nucliadb_tpu_torch.sdk import NucliaDBClient
    from nucliadb_tpu_torch.models.api import FindRequest, SearchFeature
    from tests.torch_test_helpers import standalone_app

    StandaloneApp = standalone_app("nucliadb_tpu_torch")
    app = StandaloneApp(data_dir=str(tmp_path / "srv"), host="127.0.0.1", port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.server.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    started.wait(10)

    client = NucliaDBClient(base_url=f"http://127.0.0.1:{app.server.port}")
    kb = client.create_kb(KnowledgeBoxConfig(slug="sdk-kb"))
    created = client.create_resource(
        kb.uuid,
        CreateResourcePayload(title="Hello", texts={"t": TextFieldPayload(body="hello sdk world")}),
    )
    res = client.find(kb.uuid, FindRequest(query="sdk", features=[SearchFeature.KEYWORD]))
    assert created.uuid in res.resources
    # files: plain + resumable TUS round trips
    client.upload_file(
        kb.uuid, created.uuid, "att", b"plain bytes", filename="a.bin"
    )
    assert client.download_file(kb.uuid, created.uuid, "att") == b"plain bytes"
    big = b"x" * (3 * 1024) + b"END"
    client.tus_upload(
        kb.uuid, created.uuid, "big", big, filename="big.bin", chunk_size=1024
    )
    assert client.download_file(kb.uuid, created.uuid, "big") == big
    # regression: zero-byte uploads must still send the finalizing PATCH
    client.tus_upload(kb.uuid, created.uuid, "empty", b"", filename="e.bin")
    assert client.download_file(kb.uuid, created.uuid, "empty") == b""

    # notifications: cursor + live SSE stream
    notes = client.notifications(kb.uuid)
    assert any(n["action"] == "created" for n in notes)
    sse = next(iter(client.notifications_stream(kb.uuid, timeout=2)))
    assert sse["action"] == "created"

    # vocabulary + export/import + openapi
    client.set_labelset(kb.uuid, "topic", {"title": "T", "labels": [{"title": "x"}]})
    assert "topic" in client.get_labelsets(kb.uuid)
    client.set_synonyms(kb.uuid, {"hello": ["hi"]})
    blob = client.export_kb(kb.uuid)
    copy_id = client.import_kb(blob, slug="sdk-copy")
    assert copy_id
    assert "/api/v1/kb/{kbid}/find" in client.openapi()["paths"]

    # streaming ask
    items = list(
        client.ask_stream(kb.uuid, AskRequest(query="hello"))
    )
    assert items[-1]["type"] == "status"

    # full-surface coverage: vocab getters, vectorsets, counters, feedback,
    # graph subqueries, hydrate, status, configuration, trainset, backups,
    # admin
    assert client.get_labelset(kb.uuid, "topic")["title"] == "T"
    assert client.get_synonyms(kb.uuid)["synonyms"] == {"hello": ["hi"]}
    client.set_entities_group(kb.uuid, "things", {"title": "Things", "entities": {}})
    assert client.get_entities_group(kb.uuid, "things")["title"] == "Things"
    client.delete_entities_group(kb.uuid, "things")
    assert client.list_vectorsets(kb.uuid) == {"vectorsets": {}}
    listing = client.list_resources(kb.uuid)
    assert created.uuid in [r["id"] for r in listing["resources"]]
    assert client.counters(kb.uuid)["resources"] >= 1
    client.feedback(kb.uuid, {"ident": "q1", "good": True, "task": "CHAT"})
    client.reindex_resource(kb.uuid, created.uuid)
    nodes = client.graph_nodes(kb.uuid)
    assert "nodes" in nodes
    hyd = client.hydrate(kb.uuid, fields=[f"{created.uuid}/t/t"])
    assert hyd["texts"][f"{created.uuid}/t/t"] == "hello sdk world"
    assert client.processing_status(kb.uuid)["results"] is not None
    client.patch_configuration(kb.uuid, {"generative_model": "g"})
    assert client.get_configuration(kb.uuid)["generative_model"] == "g"
    assert client.list_search_configurations(kb.uuid) == {}
    # learning extras: strict POST, schemas, providers, strategies
    client.set_configuration(kb.uuid, {"generative_model": "g2"})
    assert client.get_configuration(kb.uuid)["generative_model"] == "g2"
    assert "semantic_model" in client.configuration_schema(kb.uuid)["properties"]
    assert "semantic_model" in client.nua_schema()["properties"]
    assert client.generative_providers(kb.uuid)["providers"]["local"]["default"] == "g2"
    sid = client.add_strategy(kb.uuid, "extract", {"name": "s1"})
    assert sid in client.list_strategies(kb.uuid, "extract")
    client.delete_strategy(kb.uuid, "extract", sid)
    assert client.list_strategies(kb.uuid, "extract") == {}
    manifest = client.export_trainset(kb.uuid, "sentences", batch_size=8)
    assert manifest["format"] == "arrow"
    backup_id = client.backup_kb(kb.uuid)
    assert backup_id in client.list_backups()
    restored = client.restore_backup(backup_id, slug="sdk-restored")
    assert restored
    client.delete_backup(backup_id)
    assert backup_id not in client.list_backups()
    assert "merged" in client.admin_tick()
    assert client.admin_shards(kb.uuid)["shards"]
    assert client.set_log_level("nucliadb_tpu_torch.sdk", "INFO")["level"] == "INFO"

    # standalone introspection
    assert "nucliadb_tpu" in client.versions()
    assert client.config_check()["user"]["roles"]
    assert client.temp_access_token()

    # raw retrieval + resource-scoped calls + train REST
    matches = client.retrieve(kb.uuid, {"query": {"keyword": "sdk"}}).matches
    assert matches and matches[0].score.type == "rrf"
    rsearch = client.resource_search(kb.uuid, created.uuid, "hello")
    assert rsearch["paragraphs"]["results"]
    rask = client.resource_ask(kb.uuid, created.uuid, AskRequest(query="hello"))
    assert created.uuid in (rask.retrieval.resources if rask.retrieval else {})
    agents = client.run_agents(kb.uuid, created.uuid)
    assert "/t/t" in agents["results"]
    parts = client.trainset_partitions(kb.uuid)
    assert parts
    stream = client.trainset_stream(kb.uuid, parts[0], "FIELD_STREAMING")
    import io as _io

    import pyarrow as _pa

    assert sum(rb.num_rows for rb in _pa.ipc.open_stream(_io.BytesIO(stream))) >= 1

    client.delete_resource(kb.uuid, created.uuid)
    client.delete_kb(kb.uuid)
    client.close()
    loop.call_soon_threadsafe(loop.stop)


def test_new_train_generators(tmp_path):
    import json

    from nucliadb_tpu_torch.train.dataset import GENERATORS
    from nucliadb_tpu_torch.train.generators import TrainSet

    driver = Driver(str(tmp_path / "db.sqlite"))
    node = EmbeddedNode(data_dir=str(tmp_path / "node"), device="cpu")
    kbs = KnowledgeBoxManager(driver, node)
    kbid = kbs.create(KnowledgeBoxConfig(slug="train2"))
    processor = Processor(driver, node, kbs)
    rid, _ = processor.create_resource(
        kbid,
        CreateResourcePayload(
            title="Doc",
            texts={"t": TextFieldPayload(body="First sentence. Second one!\n\nNew para.")},
            usermetadata=UserMetadata(
                classifications=[Classification(labelset="topic", label="x")]
            ),
        ),
    )
    # an image file field for the image classifier
    node.storage.put(f"blobs/{kbid}/{rid}/pic", b"\x89PNG fake")
    with driver as txn:
        txn.set(
            f"/kbs/{kbid}/r/{rid}/files/pic",
            json.dumps(
                {"key": f"blobs/{kbid}/{rid}/pic", "content_type": "image/png",
                 "filename": "p.png", "size": 9}
            ).encode(),
        )

    ts = TrainSet(kbid=kbid, batch_size=8)
    sc = list(GENERATORS["sentence_classification"](processor, ts))
    assert sc and "First sentence." in sc[0].texts
    assert all(l == ["/l/topic/x"] for l in sc[0].labels)

    fs = list(GENERATORS["field_streaming"](processor, ts))
    assert fs and "a/title" in fs[0].fields

    ps = list(GENERATORS["paragraph_streaming"](processor, ts))
    assert ps and any(p.startswith(rid) for p in ps[0].paragraph_ids)

    ic = list(GENERATORS["image_classification"](processor, ts))
    assert ic and ic[0].content_types == ["image/png"]
    assert node.storage.get(ic[0].blob_keys[0]) == b"\x89PNG fake"


def test_migration_lock(stack):
    import pytest

    from nucliadb_tpu_torch.migrator import migration_lock

    node, driver, kbs, processor, kbid = stack
    with migration_lock(driver):
        with pytest.raises(TimeoutError):
            with migration_lock(driver, timeout=0.2):
                pass
    # released: can take it again
    with migration_lock(driver, timeout=0.2):
        pass


def test_bootstrap_and_builtin_migrations(tmp_path):
    from nucliadb_tpu_torch.common.kb import RESOURCE_SLUG, KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.migrator import (
        MigrationContext,
        _REGISTRY,
        bootstrap_version,
        current_version,
        latest_version,
        run_migrations,
    )
    from nucliadb_tpu_torch.migrator import migrations as _builtin  # registers
    from nucliadb_tpu_torch.models.api import CreateResourcePayload, KnowledgeBoxConfig
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.storage import MemoryStorage

    assert any(m.name == "backfill-resource-slug-keys" for m in _REGISTRY)

    # fresh deployment: bootstrap to latest, nothing replays
    driver = Driver(str(tmp_path / "kv.db"))
    bootstrap_version(driver)
    assert current_version(driver) == latest_version() >= 2

    # existing deployment with a missing slug key: migration backfills it
    driver2 = Driver(str(tmp_path / "kv2.db"))
    node = EmbeddedNode(data_dir=str(tmp_path / "node"), storage=MemoryStorage(), device="cpu")
    kbs = KnowledgeBoxManager(driver2, node)
    processor = Processor(driver2, node, kbs)
    kbid = kbs.create(KnowledgeBoxConfig(slug="migkb"))
    rid, _ = processor.create_resource(
        kbid, CreateResourcePayload(slug="my-slug", title="T")
    )
    slug_key = RESOURCE_SLUG.format(kbid=kbid, slug="my-slug")
    with driver2 as txn:
        txn.delete(slug_key)  # simulate pre-slug-twin data
    applied = run_migrations(
        MigrationContext(driver=driver2, node=node, kbs=kbs, processor=processor)
    )
    assert "backfill-resource-slug-keys" in applied
    with driver2 as txn:
        assert txn.get(slug_key) == rid.encode()
    # idempotent: a second run applies nothing
    assert run_migrations(
        MigrationContext(driver=driver2, node=node, kbs=kbs, processor=processor)
    ) == []


def test_train_grpc_streams(stack):
    """Train batches stream over gRPC (parity: the Train servicer,
    train/servicer.py:47-110) — every registered task is a method."""
    from nucliadb_tpu_torch.grpc_plane import TrainClient, TrainGrpcServer
    from nucliadb_tpu_torch.train.dataset import GENERATORS

    node, driver, kbs, processor, kbid = stack
    server = TrainGrpcServer(processor)
    server.start()
    client = TrainClient(f"127.0.0.1:{server.port}")
    try:
        batches = list(client.batches("paragraph_classification", kbid, batch_size=8))
        texts = [t for b in batches for t in b["texts"]]
        assert "The fox is quick." in texts
        labels = [l for b in batches for l in b["labels"]]
        assert ["/l/topic/animals"] in labels

        # labelset restriction flows through
        fin = list(client.batches("field_classification", kbid, labelset="topic"))
        assert fin and all(l for b in fin for l in b["labels"])

        # every generator task is servable
        for task in GENERATORS:
            list(client.batches(task, kbid, batch_size=4))
    finally:
        client.close()
        server.stop()


def test_migration_lock_cas_and_renewal(tmp_path):
    """The lock acquires via atomic CAS, renews while held, and expired
    leases are stolen (review regressions)."""
    import json as _json
    import time as _time

    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.migrator import LOCK_KEY, migration_lock

    driver = Driver(str(tmp_path / "kv.db"))
    # CAS primitives
    assert driver.compare_and_swap("/k", None, b"a")
    assert not driver.compare_and_swap("/k", None, b"b")  # exists
    assert driver.compare_and_swap("/k", b"a", b"b")
    assert not driver.compare_and_swap("/k", b"a", b"c")  # stale expected
    assert driver.delete_if("/k", b"b")

    # an expired lease is stolen atomically
    stale = _json.dumps({"owner": "dead", "expires": _time.time() - 1}).encode()
    with driver as txn:
        txn.set(LOCK_KEY, stale)
    with migration_lock(driver, timeout=1.0):
        with driver as txn:
            holder = _json.loads(txn.get(LOCK_KEY))
        assert holder["owner"] != "dead"
        assert holder["expires"] > _time.time()
    with driver as txn:
        assert txn.get(LOCK_KEY) is None  # released


def test_ops_tool_cli(tmp_path):
    """The ops tool (parity: nidx tool + import/export utilities) round-trips
    export/import/backup/restore against a data dir without a server."""
    import subprocess
    import sys

    from nucliadb_tpu_torch.tool import _stack

    data = str(tmp_path / "data")
    node, kbs, processor = _stack(data, "cpu")
    kbid = kbs.create(KnowledgeBoxConfig(slug="toolkb"))
    processor.create_resource(
        kbid, CreateResourcePayload(title="T", texts={"t": TextFieldPayload(body="tool body")})
    )
    node.wait_for_sync()

    def run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "nucliadb_tpu_torch.tool", "--data-dir", data, "--device", "cpu", *args],
            capture_output=True, text=True,
        )
        assert out.returncode == 0, out.stderr
        return out.stdout.strip()

    assert kbid in run("list-kbs")
    exp = str(tmp_path / "kb.export")
    run("export-kb", kbid, exp)
    assert "imported ->" in run("import-kb", exp, "--slug", "tool-copy")
    backup_id = run("backup", kbid)
    assert backup_id in run("list-backups")
    assert "restored ->" in run("restore", backup_id, "--slug", "tool-restored")
    stats = run("shards", kbid)
    assert "text: 1 segments" in stats and "(writable)" in stats


def test_stale_text_format_migration(tmp_path):
    """Segments written before TEXT_FORMAT_VERSION (no /f facets) trigger a
    rollover reindex; fresh segments do not."""
    import json as _json

    from nucliadb_tpu_torch.migrator.migrations import _reindex_stale_text_formats
    from nucliadb_tpu_torch.migrator import MigrationContext
    from nucliadb_tpu_torch.models.api import FindRequest, SearchFeature
    from nucliadb_tpu_torch.search import SearchService

    driver = Driver(str(tmp_path / "db.sqlite"))
    node = EmbeddedNode(data_dir=str(tmp_path / "node"), device="cpu")
    kbs = KnowledgeBoxManager(driver, node)
    kbid = kbs.create(KnowledgeBoxConfig(slug="fmt-kb"))
    processor = Processor(driver, node, kbs)
    processor.create_resource(
        kbid,
        CreateResourcePayload(title="v2 doc", texts={"t": TextFieldPayload(body="format body")}),
    )
    node.wait_for_sync()
    ctx = MigrationContext(driver=driver, node=node, kbs=kbs, processor=processor)

    old_shards = kbs.get_shards(kbid).shards
    # fresh segments are already v2 -> no rollover
    _reindex_stale_text_formats(ctx, kbid)
    assert kbs.get_shards(kbid).shards == old_shards

    # age one text segment's recorded format -> migration must roll over
    aged = 0
    for shard_id in old_shards:
        for idx in node.metadata.get_indexes(shard_id):
            if idx.kind not in ("text", "paragraph"):
                continue
            for seg in node.metadata.ready_segments(idx.id):
                meta = dict(seg.index_metadata)
                meta.pop("format_version", None)
                with node.metadata._conn as conn:
                    conn.execute(
                        "UPDATE segments SET index_metadata=? WHERE id=?",
                        (_json.dumps(meta), seg.id),
                    )
                aged += 1
    assert aged, "expected at least one text segment to age"
    _reindex_stale_text_formats(ctx, kbid)
    new_shards = kbs.get_shards(kbid).shards
    assert set(new_shards) != set(old_shards)
    node.wait_for_sync()
    search = SearchService(node, kbs, processor)
    out = search.find(
        kbid,
        FindRequest(query="format body", features=[SearchFeature.KEYWORD],
                    filters=["/field/t"]),
    )
    assert out.resources, "reindexed segments must carry the /f facets"


def test_migration_lock_lease_stamped_at_acquisition(tmp_path):
    """Regression: the lease payload (with its expiry) was built once BEFORE
    the contended wait loop, so a long wait installed an already-stale lease
    a third process could immediately steal."""
    import json as _json
    import time as _time

    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.migrator import LOCK_KEY, LOCK_TTL, migration_lock

    driver = Driver(str(tmp_path / "kv.db"))
    holder = _json.dumps({"owner": "other", "expires": _time.time() + 0.6}).encode()
    with driver as txn:
        txn.set(LOCK_KEY, holder)
    t0 = _time.time()
    with migration_lock(driver, timeout=10):
        waited = _time.time() - t0
        assert waited >= 0.5  # the lock was actually contended
        with driver as txn:
            lease = _json.loads(txn.get(LOCK_KEY))
        assert lease["expires"] >= t0 + waited + LOCK_TTL * 0.9


def test_stale_vector_format_migration_sees_unversioned(tmp_path, monkeypatch):
    """Regression: segments lacking format_version defaulted to the CURRENT
    version, so the exact population the migration targets was skipped."""
    from nucliadb_tpu_torch.common.kb import KnowledgeBoxManager
    from nucliadb_tpu_torch.ingest.processor import Processor
    from nucliadb_tpu_torch.maindb import Driver
    from nucliadb_tpu_torch.migrator import MigrationContext
    from nucliadb_tpu_torch.migrator import migrations as mig
    from nucliadb_tpu_torch.models.api import (
        CreateResourcePayload,
        KnowledgeBoxConfig,
        SentenceEmbedding,
        TextFieldPayload,
        VectorSetSpec,
    )
    from nucliadb_tpu_torch.services import EmbeddedNode
    from nucliadb_tpu_torch.storage import MemoryStorage

    node = EmbeddedNode(data_dir=str(tmp_path / "node"), storage=MemoryStorage(), device="cpu")
    driver = Driver(str(tmp_path / "kv.db"))
    kbs = KnowledgeBoxManager(driver, node)
    processor = Processor(driver, node, kbs)
    kbid = kbs.create(
        KnowledgeBoxConfig(slug="fmt", vectorsets={"m": VectorSetSpec(dimension=8)})
    )
    body = "format test"
    processor.create_resource(
        kbid,
        CreateResourcePayload(
            title="t",
            texts={"t": TextFieldPayload(body=body)},
            embeddings={
                "m": {"t": [SentenceEmbedding(start=0, end=len(body), vector=[0.1] * 8)]}
            },
        ),
    )
    node.wait_for_sync()
    # simulate pre-versioning segments: strip format_version everywhere
    with node.metadata._lock, node.metadata._conn:
        node.metadata._conn.execute("UPDATE segments SET index_metadata = '{}'")
    calls = []
    import nucliadb_tpu_torch.common.rollover as ro

    monkeypatch.setattr(ro, "rollover_kb", lambda *a, **k: calls.append(a))
    ctx = MigrationContext(driver=driver, node=node, kbs=kbs, processor=processor)
    mig._reindex_stale_vector_formats(ctx, kbid)
    assert calls, "unversioned vector segments must trigger the reindex"

"""The two packages' host modules of the ops path agree, crossed both ways.

- **OTLP.** The same ``SpanRecord`` list, built from a seed in each
  package, encodes to the same ``ExportTraceServiceRequest`` bytes.
- **Signatures.** ``s3.sign_v4`` (at a fixed clock) and
  ``azure.sign_shared_key`` give the same headers in both packages.
- **Cloud objects.** Against one protocol fake, objects that one package's
  S3, GCS or Azure storage writes are read, listed and deleted by the
  other's.
- **Tasks.** On one bus file a task sent by either package's producer is
  consumed by the other's consumer; a poisoned task lands on the
  dead-letter subject, which both packages read alike.
- **Ops tool.** A KB export written by one package's ``tool`` imports
  through the other's (the port's with ``--device cpu``), and ``/find``
  over the imported KB answers as over the writer's own import of it.
- **SDK.** Each package's ``NucliaDBClient`` against the other's
  ``StandaloneApp``: both clients parse equal answers from one server, and
  with the packages' ``uuid4`` aligned the two crossings answer alike.
- **Migrator.** A data directory that one package wrote with migrations
  pending is migrated by the other's CLI; both packages then read the same
  ``current_version`` and a dry run lists nothing pending.
- **No fallback.** ``tool`` and ``migrator`` with ``--device cuda`` on a
  machine without a card raise before they open a file.
"""

import base64
import datetime
import importlib
import itertools
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest

from tests.test_torch_standalone_parity import DIM, _corpus, _drop_wall_clock
from tests.torch_test_helpers import assert_plain_close, serving, standalone_app

PACKAGES = ("nucliadb_tpu", "nucliadb_tpu_torch")
CROSSED = [PACKAGES, PACKAGES[::-1]]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cli_args(pkg):
    """The port's CLIs run on the CPU here; the JAX package's take no device."""
    return ["--device", "cpu"] if pkg == "nucliadb_tpu_torch" else []


# ---------------------------------------------------------------------------
# OTLP
# ---------------------------------------------------------------------------


def _span_specs(seed, n=12):
    """Plain span descriptions from a seed: hex ids (one span with ids that
    are not hex, which the encoder drops), parents, times and attributes of
    every AnyValue kind."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n):
        attrs = {}
        for j in range(int(rng.integers(0, 5))):
            kind = int(rng.integers(0, 4))
            key = f"a{j}"
            attrs[key] = (
                f"v{int(rng.integers(0, 1000))}", bool(rng.integers(0, 2)),
                int(rng.integers(-2**40, 2**40)), float(rng.standard_normal()),
            )[kind]
        trace = rng.bytes(16).hex() if i != 5 else "g" * 32
        start = float(rng.uniform(1.6e9, 1.7e9))
        specs.append(dict(
            name=f"span-{i}", trace_id=trace, span_id=rng.bytes(8).hex(),
            parent_id=rng.bytes(8).hex() if i % 3 else "",
            start=start, end=start + float(rng.uniform(0, 2)), attributes=attrs,
        ))
    return specs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otlp_export_request_bytes_equal(seed):
    bodies = []
    for pkg in PACKAGES:
        SpanRecord = _mod(pkg, "telemetry.tracing").SpanRecord
        otlp = _mod(pkg, "telemetry.otlp")
        records = [SpanRecord(**spec) for spec in _span_specs(seed)]
        bodies.append(otlp.encode_export_request(f"svc-{seed}", records))
    assert bodies[0] == bodies[1]
    # every span but the poisoned one is in the request
    assert b"span-4" in bodies[0] and b"span-5" not in bodies[0]
    # each package's decoder reads the other's bytes the same way
    decoded = [_mod(pkg, "grpc_plane.protowire").decode(_mod(pkg, "telemetry.otlp").EXPORT_TRACE_SERVICE_REQUEST, body)
               for pkg, body in zip(PACKAGES, bodies[::-1])]
    assert decoded[0] == decoded[1]


# ---------------------------------------------------------------------------
# S3 and Azure request signing
# ---------------------------------------------------------------------------


def _signing_inputs(seed):
    rng = np.random.default_rng(seed)
    method = ("GET", "PUT", "DELETE", "HEAD")[int(rng.integers(0, 4))]
    path = "/" + "/".join(f"k{int(x)} é+%" if x % 3 == 0 else f"k{int(x)}" for x in rng.integers(0, 100, 3))
    query = {f"q{int(x)}": f"v {int(x)}/x" for x in rng.integers(0, 50, int(rng.integers(0, 4)))}
    headers = {"Content-Type": "application/octet-stream", "x-ms-version": "2023-11-03",
               f"x-ms-meta-k{seed}": f" v{int(rng.integers(0, 9))} "}
    payload = rng.bytes(int(rng.integers(0, 64)))
    return method, path, query, headers, payload


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_s3_and_azure_signatures_equal(seed):
    import hashlib

    method, path, query, headers, payload = _signing_inputs(seed)
    now = datetime.datetime(2026, 1, 2, 3, 4, 5, tzinfo=datetime.timezone.utc)
    key = base64.b64encode(np.random.default_rng(seed).bytes(32)).decode()
    s3_headers, azure = [], []
    for pkg in PACKAGES:
        s3 = _mod(pkg, "storage.s3")
        s3_headers.append(s3.sign_v4(
            method, "bucket.example:9000", path, query, headers, hashlib.sha256(payload).hexdigest(),
            access_key="AKID", secret_key="sekrit", region="eu-west-3", now=now,
        ))
        azure.append(_mod(pkg, "storage.azure").sign_shared_key(
            method, "acct", path, query, headers, key, len(payload)))
    assert s3_headers[0] == s3_headers[1] and "Authorization" in s3_headers[0]
    assert azure[0] == azure[1] and azure[0].startswith("SharedKey acct:")


# ---------------------------------------------------------------------------
# cloud objects crossing packages
# ---------------------------------------------------------------------------


def _fake(backend):
    import cloud_fakes

    key = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()
    if backend == "s3":
        server, endpoint, _ = cloud_fakes.make_fake_s3("ndb", "AKID", "sekrit")
        fields = dict(bucket="ndb", access_key="AKID", secret_key="sekrit", key_prefix="kb1/")
    elif backend == "gcs":
        server, endpoint, _ = cloud_fakes.make_fake_gcs("ndb", "tok123")
        fields = dict(bucket="ndb", token="tok123", key_prefix="kb1/")
    else:
        server, endpoint, _ = cloud_fakes.make_fake_azure("acct", key, "ndb")
        fields = dict(account="acct", account_key=key, container="ndb", key_prefix="kb1/")
    return server, dict(fields, backend=backend, endpoint=endpoint)


def _storage(pkg, fields):
    settings = _mod(pkg, "settings").StorageSettings(**fields)
    return _mod(pkg, "storage").make_storage(settings)


@pytest.mark.parametrize("writer,reader", CROSSED)
@pytest.mark.parametrize("backend", ["s3", "gcs", "azure"])
def test_cloud_objects_cross_packages(backend, writer, reader):
    server, fields = _fake(backend)
    try:
        w, r = _storage(writer, fields), _storage(reader, fields)
        rng = np.random.default_rng(11)
        objects = {f"seg/{i:02d}": rng.bytes(int(rng.integers(1, 4096))) for i in range(5)}
        objects["dir/a b é.bin"] = b"tricky"
        for key, blob in objects.items():
            w.put(key, blob)
        assert list(r.list("seg/")) == sorted(k for k in objects if k.startswith("seg/"))
        assert list(r.list()) == sorted(objects)
        assert all(r.get(k) == blob for k, blob in objects.items())
        r.delete("seg/02")
        assert not w.exists("seg/02") and w.exists("seg/03")
        r.put("seg/02", b"back")
        assert w.get("seg/02") == b"back"
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# tasks over one bus file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("producer_pkg,consumer_pkg", CROSSED)
def test_tasks_cross_packages_on_one_bus(producer_pkg, consumer_pkg, tmp_path):
    path = str(tmp_path / "bus.db")
    ptasks, ctasks = _mod(producer_pkg, "tasks"), _mod(consumer_pkg, "tasks")
    pbus = _mod(producer_pkg, "bus").EmbeddedBus(path)
    cbus = _mod(consumer_pkg, "bus").EmbeddedBus(path, ack_wait=0.0)
    done = []
    producer = ptasks.TaskProducer(pbus, "reindex")
    consumer = ctasks.TaskConsumer(cbus, "reindex", lambda t: done.append((t.kbid, t.payload)))
    producer.send("kb1", rid="r1", n=3)
    producer.send("kb2", rid="r2")
    assert consumer.drain() == 2
    assert done == [("kb1", {"rid": "r1", "n": 3}), ("kb2", {"rid": "r2"})]

    attempts = []

    def boom(task):
        attempts.append(task.kbid)
        raise RuntimeError("poison")

    max_deliveries = _mod(consumer_pkg, "bus.stream").MAX_DELIVERIES
    assert max_deliveries == _mod(producer_pkg, "bus.stream").MAX_DELIVERIES
    poisoned = ctasks.TaskConsumer(cbus, "poison", boom)
    ptasks.TaskProducer(pbus, "poison").send("kbp", rid="bad")
    for _ in range(max_deliveries + 2):
        poisoned.work_once()
    assert attempts == ["kbp"] * max_deliveries
    # the dead letter reads the same through either package
    for letters in (poisoned.dead_letters(), ptasks.TaskConsumer(pbus, "poison", boom).dead_letters()):
        assert [(m.kbid, m.payload) for m in letters] == [("kbp", {"rid": "bad"})]


# ---------------------------------------------------------------------------
# the ops tool: a KB export crossing packages
# ---------------------------------------------------------------------------


def _tool_stack(pkg, data):
    tool = _mod(pkg, "tool")
    node, kbs, processor = tool._stack(data, "cpu") if pkg == "nucliadb_tpu_torch" else tool._stack(data)
    return node, kbs, processor, _mod(pkg, "search").SearchService(node, kbs, processor)


def _finds(pkg, search, kbid, q):
    FindRequest = _mod(pkg, "models.api").FindRequest
    reqs = (
        {"query": "quick fox river", "vector": q, "top_k": 8},
        {"query": "market stock", "features": ["keyword"], "top_k": 8},
        {"query": "", "vector": q, "features": ["semantic"], "top_k": 8},
    )
    return [_drop_wall_clock(search.find(kbid, FindRequest.model_validate(r)).model_dump(mode="json"))
            for r in reqs]


def _tool_import(pkg, data, export, capsys):
    capsys.readouterr()
    assert _mod(pkg, "tool").main(["--data-dir", data, *_cli_args(pkg), "import-kb", export, "--slug", "copy"]) == 0
    return capsys.readouterr().out.strip().splitlines()[-1].split("-> ")[1]


@pytest.mark.parametrize("writer,reader", CROSSED)
def test_tool_export_imports_across_packages(writer, reader, tmp_path, capsys):
    """The writer's export imports through the reader's tool and through the
    writer's own; ``/find`` over the two imported KBs answers alike. (An
    import re-indexes the resources in the export's order, so a hybrid
    ranking's ties may fall differently than over the original KB, in
    either package.)"""
    api = _mod(writer, "models.api")
    corpus = _corpus(6, seed=5)
    q = corpus[2]["embeddings"]["m"]["body"][0]["vector"]
    src = str(tmp_path / "src")
    node, kbs, processor, _ = _tool_stack(writer, src)
    kbid = kbs.create(api.KnowledgeBoxConfig(slug="src", vectorsets={"m": api.VectorSetSpec(dimension=DIM)}))
    rids = [processor.create_resource(kbid, api.CreateResourcePayload.model_validate(p)) for p in corpus]
    node.wait_for_sync()

    export = str(tmp_path / "kb.export")
    assert _mod(writer, "tool").main(["--data-dir", src, *_cli_args(writer), "export-kb", kbid, export]) == 0
    answers = {}
    for pkg in (writer, reader):
        data = str(tmp_path / f"dst-{pkg}")
        new_kbid = _tool_import(pkg, data, export, capsys)
        node2, kbs2, processor2, search2 = _tool_stack(pkg, data)
        assert len(processor2.list_resources(new_kbid)) == len(rids)
        answers[pkg] = _finds(pkg, search2, new_kbid, q)
    assert all(a["resources"] for a in answers[writer])
    assert_plain_close(answers[reader], answers[writer])


# ---------------------------------------------------------------------------
# the SDK crossing servers
# ---------------------------------------------------------------------------


def _sdk_writes(client_pkg, client, corpus):
    api = _mod(client_pkg, "models.api")
    kb = client.create_kb(api.KnowledgeBoxConfig(slug="sdk", vectorsets={"m": api.VectorSetSpec(dimension=DIM)}))
    rids = [client.create_resource(kb.uuid, api.CreateResourcePayload.model_validate(p)).uuid for p in corpus]
    return kb.uuid, rids


def _sdk_reads(client_pkg, client, kbid, rids, q):
    api = _mod(client_pkg, "models.api")

    def dump(obj):
        return _drop_wall_clock(obj.model_dump(mode="json") if hasattr(obj, "model_dump") else obj)

    return [dump(x) for x in (
        client.find(kbid, api.FindRequest(query="quick fox river", vector=q, top_k=8)),
        client.find(kbid, api.FindRequest(query="", vector=q, features=["semantic"], top_k=8)),
        client.find(kbid, api.FindRequest(query="market stock", features=["keyword"], top_k=8)),
        client.suggest(kbid, api.SuggestRequest(query="riv")),
        client.catalog(kbid, api.CatalogRequest(faceted=["/l/topic"])),
        client.get_kb(kbid),
        client.get_resource(kbid, rids[1]),
        client.list_resources(kbid),
    )]


@pytest.fixture(scope="module")
def sdk_sessions(tmp_path_factory):
    """For each server package: the other package's client writes a KB, then
    both packages' clients read it; every ``uuid4`` the server's package
    draws comes from one sequence, the same for both servers."""
    corpus = _corpus(8, seed=9)
    q = corpus[3]["embeddings"]["m"]["body"][0]["vector"]
    out = {}
    for server_pkg in PACKAGES:
        writer = PACKAGES[1 - PACKAGES.index(server_pkg)]
        counter, real = itertools.count(1), uuid.uuid4

        def uuid4(pkg=server_pkg, counter=counter, real=real):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            return uuid.UUID(int=next(counter)) if caller.split(".")[0] == pkg else real()

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(uuid, "uuid4", uuid4)
            app = standalone_app(server_pkg)(data_dir=str(tmp_path_factory.mktemp(server_pkg)),
                                             host="127.0.0.1", port=0)
            try:
                with serving(app) as http:
                    base = str(http.base_url)
                    clients = {pkg: _mod(pkg, "sdk").NucliaDBClient(base) for pkg in PACKAGES}
                    kbid, rids = _sdk_writes(writer, clients[writer], corpus)
                    out[server_pkg] = {pkg: _sdk_reads(pkg, c, kbid, rids, q) for pkg, c in clients.items()}
                    for c in clients.values():
                        c.close()
            finally:
                app.stop_background()
    return out


@pytest.mark.parametrize("server_pkg", PACKAGES)
def test_sdk_clients_parse_equal_answers(sdk_sessions, server_pkg):
    answers = sdk_sessions[server_pkg]
    assert answers[PACKAGES[0]] == answers[PACKAGES[1]]
    assert answers[PACKAGES[0]][0]["resources"] and answers[PACKAGES[0]][2]["resources"]


def test_sdk_crossings_answer_alike(sdk_sessions):
    """The port's client against the JAX server and the JAX package's client
    against the port's server parse equal answers."""
    port_on_jax = sdk_sessions["nucliadb_tpu"]["nucliadb_tpu_torch"]
    jax_on_port = sdk_sessions["nucliadb_tpu_torch"]["nucliadb_tpu"]
    assert_plain_close(port_on_jax, jax_on_port)


# ---------------------------------------------------------------------------
# the migrator CLI crossing packages
# ---------------------------------------------------------------------------


def _run_migrator(pkg, data, *extra, monkeypatch, capsys):
    """The port's CLI as a subprocess (the command a user runs); the JAX
    package's in process (its interpreter would load jax again)."""
    if pkg == "nucliadb_tpu_torch":
        out = subprocess.run(
            [sys.executable, "-m", "nucliadb_tpu_torch.migrator", "--data-dir", data, "--device", "cpu", *extra],
            capture_output=True, text=True, cwd=ROOT, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        return out.stdout
    main = importlib.import_module("nucliadb_tpu.migrator.__main__").main
    monkeypatch.setattr(sys, "argv", ["migrator", "--data-dir", data, *extra])
    capsys.readouterr()
    main()
    return capsys.readouterr().out


@pytest.mark.parametrize("writer,migrator", CROSSED)
def test_migrator_cli_migrates_the_other_packages_data(writer, migrator, tmp_path, monkeypatch, capsys):
    data = str(tmp_path / "data")
    api = _mod(writer, "models.api")
    node, kbs, processor, _ = _tool_stack(writer, data)
    kbid = kbs.create(api.KnowledgeBoxConfig(slug="mig"))
    processor.create_resource(kbid, api.CreateResourcePayload(title="T", texts={"t": {"body": "migrate me"}}))
    node.wait_for_sync()
    versions = {}
    for pkg in PACKAGES:
        mig = _mod(pkg, "migrator")
        importlib.import_module(f"{pkg}.migrator.migrations")  # registers them
        versions[pkg] = (mig, mig.latest_version())
    assert versions[PACKAGES[0]][1] == versions[PACKAGES[1]][1] > 0
    latest = versions[PACKAGES[0]][1]
    assert versions[writer][0].current_version(_mod(writer, "maindb").Driver(os.path.join(data, "maindb.db"))) == 0

    out = _run_migrator(migrator, data, monkeypatch=monkeypatch, capsys=capsys)
    assert "pending: ['" in out and "applied: ['" in out
    for pkg in PACKAGES:
        driver = _mod(pkg, "maindb").Driver(os.path.join(data, "maindb.db"))
        assert versions[pkg][0].current_version(driver) == latest
    assert "pending: []" in _run_migrator(migrator, data, "--dry-run", monkeypatch=monkeypatch, capsys=capsys)


# ---------------------------------------------------------------------------
# no fallback to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["nucliadb_tpu_torch.tool", "list-kbs"],
    ["nucliadb_tpu_torch.migrator", "--dry-run"],
])
def test_cuda_cli_without_a_card_raises_before_it_opens_anything(argv, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda command is valid here")
    data = str(tmp_path / "data")
    out = subprocess.run(
        [sys.executable, "-m", argv[0], "--data-dir", data, *argv[1:]],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert not os.path.exists(data)

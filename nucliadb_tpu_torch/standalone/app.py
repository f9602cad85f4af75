"""Standalone application: routes (v1 REST parity) + component wiring.

Route surface mirrors the reference's v1 API (writer/api/v1, reader/api/v1,
search/api/v1): KB lifecycle, resource CRUD (+slug addressing), vectorsets,
find/search/suggest/catalog/graph/ask, health probes and Prometheus
metrics.

Counterpart of ``nucliadb_tpu/standalone/app.py``; the routes are the JAX
package's, copied. Where the port differs, a comment says why: the app
takes a torch ``device`` (default ``"cuda"``) for its node and resolves it
before it opens a file or binds a port, and the boot-time kernel warm-up
lets its failure out instead of swallowing it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from typing import Optional

from pydantic import ValidationError

from ..common.kb import KnowledgeBoxManager
from ..http import (
    HTTPError, HTTPServer, Pace, Request, Response, Router, StreamingResponse,
)
from .tus import TUS_HEADERS, TusError, TusManager, parse_upload_metadata

logger = logging.getLogger(__name__)
from ..ingest.processor import Processor
from ..maindb import Driver
from ..models.api import (
    AskRequest,
    CatalogRequest,
    CreateResourcePayload,
    FindRequest,
    GraphSearchPayload,
    KnowledgeBoxConfig,
    KnowledgeBoxObj,
    ResourceCreated,
    SearchFeature,
    SuggestRequest,
    UpdateResourcePayload,
    VectorSetSpec,
)
from ..bus import EmbeddedBus
from ..common.audit import AuditStream
from ..common.back_pressure import BackPressureMaterializer, TryAfterError
from ..common.kb_services import EntitiesService, LabelsService, SynonymsService
from ..learning_proxy import LearningProxy
from ..search import SearchService
from ..search.augmentor import AugmentRequest, Augmentor
from ..services import EmbeddedNode
from ..version import __version__


_CO_GAUGES = None

# local text extraction reads the whole blob; TUS uploads beyond this skip
# it (with a warning). Matches the HTTP MAX_BODY so any file uploadable
# through the non-resumable path extracts identically through TUS.
_EXTRACT_MAX_BYTES = 256 << 20


def _coalescer_gauges():
    """Process-wide gauges (created once: prometheus_client raises on
    duplicate registration and tests build several apps per process)."""
    global _CO_GAUGES
    if _CO_GAUGES is None:
        from ..telemetry.metrics import Gauge

        _CO_GAUGES = (
            Gauge("ndbtpu_coalescer_queries", "coalesced queries", ("index",)),
            Gauge("ndbtpu_coalescer_dispatches", "device dispatches", ("index",)),
        )
    return _CO_GAUGES


def _validate(model, data):
    try:
        return model.model_validate(data)
    except ValidationError as e:
        raise HTTPError(422, str(e))


class StandaloneApp:
    def __init__(self, data_dir: str = "./data", host: str = "127.0.0.1",
                 port: int = 8080, auth: "AuthSettings | None" = None,
                 predict=None, replica_of: "Optional[str]" = None,
                 reuse_port: bool = False, *, device="cuda"):
        """``replica_of`` (a primary's private URL) makes this process a
        READ REPLICA over the same data dir: reads serve locally, writes
        proxy to the primary, the background loop only syncs the searcher
        (standalone/workers.py — the multi-worker SO_REUSEPORT mode).
        ``reuse_port`` lets several workers bind one port. ``device`` is
        where the node's searchers hold their arenas and run."""
        from .auth import AuthSettings, make_auth_hook
        from ..utils.platform import resolve_device

        # the port has no jax backend to initialise: resolving the torch
        # device aborts boot (a cuda device without a card raises) before
        # a file is opened or a port bound
        self.device = resolve_device(device)
        os.makedirs(data_dir, exist_ok=True)
        self.auth = auth or AuthSettings()
        self.node = EmbeddedNode(data_dir=os.path.join(data_dir, "node"), device=self.device)
        self.driver = Driver(os.path.join(data_dir, "maindb.db"))
        self.kbs = KnowledgeBoxManager(self.driver, self.node)
        self.processor = Processor(self.driver, self.node, self.kbs)
        self.replica_of = replica_of
        if replica_of is None:
            self._run_boot_migrations()  # replicas: the primary owns these
        self.search = SearchService(self.node, self.kbs, self.processor, predict=predict)
        self.bus = EmbeddedBus(os.path.join(data_dir, "bus.db"))
        # buffered: one bus txn per ~0.2s batch instead of one per request
        # (the per-event commit cost ~0.5 ms of the /find hot path)
        self.audit = AuditStream(self.bus, buffered=True)
        # periodic KB storage reports ride the background scheduler tick
        self.node.scheduler.audit = self.audit
        self.back_pressure = BackPressureMaterializer(self.node.metadata, self.bus)
        self.labels = LabelsService(self.driver)
        self.entities = EntitiesService(self.driver)
        self.synonyms = SynonymsService(self.driver)
        self.learning = LearningProxy(self.driver)
        self.augmentor = Augmentor(self.processor)
        self.tus = TusManager(self.driver, self.node.storage)
        self._openapi_cache: Optional[dict] = None
        self._imports_done: set[str] = set()
        self.router = Router()
        self.server = HTTPServer(
            self.router, host, port, auth_hook=make_auth_hook(self.auth),
            reuse_port=reuse_port,
        )
        self._register_routes()
        if replica_of is not None:
            from .workers import make_forward_hook

            self.server.forward_hook = make_forward_hook(replica_of)
        self._private_server: "Optional[HTTPServer]" = None
        self._last_sync = 0.0
        self._sync_lock = threading.Lock()
        self._bg_stop = threading.Event()
        self._bg_thread: Optional[threading.Thread] = None
        # the port's warm-up state: its thread, and its seconds once it ends
        self._warmup_thread: Optional[threading.Thread] = None
        self.warmup_seconds: Optional[float] = None

    # ------------------------------------------------------------------

    def _run_boot_migrations(self) -> None:
        """Boot-time data migrations (parity: standalone/run.py:84 runs the
        migrator before serving). Fresh data dirs bootstrap at the latest
        version; existing ones replay pending migrations under the lock."""
        from ..migrator import (
            MigrationContext,
            bootstrap_version,
            migrations as _builtin,  # noqa: F401 — import registers them
            run_migrations,
        )

        if self.kbs.list_kbs():
            run_migrations(
                MigrationContext(
                    driver=self.driver, node=self.node,
                    kbs=self.kbs, processor=self.processor,
                )
            )
        else:
            bootstrap_version(self.driver)

    def _sync(self, force: bool = False) -> None:
        """Searcher freshness policy (the reference searcher syncs on a
        timer — sync.rs — and searches NEVER rebuild indexes inline):

        - with the background loop running (production), request-path sync
          is a no-op; the loop refreshes on its interval and searches serve
          the latest ready index. Under heavy ingest an inline sync would
          make every query pay an arena rebuild (measured 2.2 s/find in
          the soak).
        - without it (tests, scripts), a debounced inline sync keeps
          read-your-writes semantics.
        """
        if not force and self._bg_thread is not None and self._bg_thread.is_alive():
            return
        with self._sync_lock:
            if force or time.time() - self._last_sync > 0.2:
                self.node.wait_for_sync()
                self._last_sync = time.time()

    def _background_loop(self, interval: float = 15.0) -> None:
        while not self._bg_stop.wait(interval):
            try:
                self.node.tick_background()
                self.tus.purge_stale()
                # retention for the scan-consumed streams (nothing acks
                # them, so age bounds their growth)
                self.bus.purge_older_than("ndb_notify", 7 * 24 * 3600)
                self.bus.purge_older_than("ndb_audit", 30 * 24 * 3600)
                self._sync(force=True)
            except Exception:
                # the loop owns searcher sync — a silent persistent failure
                # here would serve stale indexes with zero diagnostics
                logger.warning("background maintenance tick failed",
                               exc_info=True)

    async def start_private_listener(self) -> int:
        """Second listener on an ephemeral localhost port (same router +
        auth): the multi-worker primary's write target. Replicas must not
        proxy to the shared SO_REUSEPORT port — the kernel could balance
        the proxied request straight back to a replica."""
        from ..http import HTTPServer as _HTTPServer

        self._private_server = _HTTPServer(
            self.router, "127.0.0.1", 0, auth_hook=self.server.auth_hook
        )
        await self._private_server.start()
        return self._private_server.port

    def _replica_loop(self, interval: float) -> None:
        """Read replicas only sync the searcher (the reference searcher's
        timer sync, nidx/src/searcher/sync.rs); scheduler/worker/purge run
        on the primary alone."""
        while not self._bg_stop.wait(interval):
            try:
                self.node.wait_for_sync()
            except Exception:
                logger.warning("replica searcher sync failed", exc_info=True)

    def start_background(self, interval: float = 15.0) -> None:
        if self.replica_of is not None:
            self._bg_thread = threading.Thread(
                target=self._replica_loop, args=(min(interval, 1.0),), daemon=True
            )
            self._bg_thread.start()
            self._start_warmup()
            return
        self._bg_thread = threading.Thread(
            target=self._background_loop, args=(interval,), daemon=True
        )
        self._bg_thread.start()
        # build and load the hand kernels off the request path: the first
        # find otherwise pays the nvcc builds
        self._start_warmup()

    def _start_warmup(self) -> None:
        # the port keeps the thread so a caller can wait for the warm-up
        # (its launches are done before counted work starts)
        self._warmup_thread = threading.Thread(target=self._warmup, daemon=True)
        self._warmup_thread.start()

    def _warmup(self) -> None:
        # not swallowed, unlike the JAX package's: a kernel that fails to
        # build must show; threading.excepthook reports the exception, and
        # the request path raises on its own (kernels load on first use)
        from ..utils.warmup import warmup_kernels

        self.warmup_seconds = warmup_kernels(self.device)

    def stop_background(self) -> None:
        self._bg_stop.set()
        self.audit.close()  # flush buffered audit events

    def _kbid(self, request: Request) -> str:
        kbid = request.params["kbid"]
        if self.kbs.get_config(kbid) is None:
            raise HTTPError(404, f"unknown knowledge box {kbid}")
        return kbid

    def _notify(self, kbid: str, rid: Optional[str], action: str, seq) -> None:
        """Activity event (parity: reader notifications / notify.{kbid})."""
        self.bus.publish(
            "ndb_notify",
            f"notify.{kbid}",
            json.dumps(
                {"kbid": kbid, "rid": rid, "action": action,
                 "seq": int(seq) if seq is not None else None, "when": time.time()}
            ).encode(),
        )

    # ------------------------------------------------------------------

    def _register_routes(self) -> None:
        r = self.router

        @r.get("/")
        def root(request: Request):
            return {"title": "nucliadb_tpu", "version": __version__}

        @r.get("/api/v1/openapi.json")
        def openapi_spec(request: Request):
            """Generated OpenAPI 3.1 schema of the live route table
            (parity: nucliadb/openapi.py component schemas)."""
            from .openapi import build_openapi

            if self._openapi_cache is None:
                self._openapi_cache = build_openapi(self.router)
            return self._openapi_cache

        @r.get("/health/alive")
        def alive(request: Request):
            return {"status": "ok"}

        @r.get("/health/ready")
        def ready(request: Request):
            return {"status": "ok"}

        _co_queries, _co_dispatches = _coalescer_gauges()

        @r.get("/metrics")
        def metrics(request: Request):
            from ..index.text_engine.batcher import coalescer as text_co
            from ..index.vector.batcher import coalescer as vec_co
            from ..telemetry.metrics import render_prometheus

            # serving-batcher observability: queries per device dispatch
            _co_queries.labels(index="vector").set(vec_co.batched_queries)
            _co_dispatches.labels(index="vector").set(vec_co.dispatches)
            _co_queries.labels(index="text").set(text_co.batched_queries)
            _co_dispatches.labels(index="text").set(text_co.dispatches)
            return 200, render_prometheus()

        # ---- knowledge boxes (writer/api/v1/knowledgebox.py parity) ----

        # ---- standalone-only introspection (standalone/api_router.py) ----

        @r.get("/api/v1/versions")
        def versions(request: Request):
            """Component versions (parity: /versions; 'latest' needs
            network egress and stays null in embedded deployments)."""
            return {
                "nucliadb_tpu": {"installed": __version__, "latest": None},
                # compatibility aliases: reference clients check these keys
                # (e2e/test_e2e.py:54-63)
                "nucliadb": {"installed": __version__, "latest": None},
                "nucliadb-admin-assets": {"installed": __version__, "latest": None},
            }

        @r.get("/api/v1/config-check")
        def config_check(request: Request):
            """Configuration sanity (parity: /config-check — NUA key state
            + the caller's resolved identity/roles)."""
            from .auth import _roles_for

            roles = _roles_for(self.auth, request) or []
            return {
                "nua_api_key": {
                    "has_key": self.search.predict is not None,
                    "valid": self.search.predict is not None,
                    "error": None,
                },
                "user": {
                    "username": request.headers.get(
                        self.auth.user_header, "anonymous"
                    ),
                    "roles": roles,
                },
            }

        @r.get("/api/v1/temp-access-token")
        def temp_access_token(request: Request):
            """Short-lived signed token carrying the caller's roles
            (parity: /temp-access-token; accepted via the eph-token query
            param so header-less contexts like download links can
            authenticate)."""
            from .auth import _roles_for, issue_temp_token

            roles = _roles_for(self.auth, request) or []
            return {
                "token": issue_temp_token(
                    self.auth,
                    request.headers.get(self.auth.user_header, "anonymous"),
                    roles,
                )
            }

        @r.post("/api/v1/kbs")
        def create_kb(request: Request):
            config = _validate(KnowledgeBoxConfig, request.json())
            try:
                kbid = self.kbs.create(config)
            except KeyError as e:
                raise HTTPError(409, str(e))
            return 201, KnowledgeBoxObj(uuid=kbid, slug=config.slug, config=config)

        @r.get("/api/v1/kbs")
        def list_kbs(request: Request):
            # parity: KnowledgeBoxList of {uuid, slug} summaries
            out = []
            for kbid in self.kbs.list_kbs():
                cfg = self.kbs.get_config(kbid)
                out.append({"uuid": kbid, "slug": cfg.slug if cfg else ""})
            return {"kbs": out}

        @r.get("/api/v1/kb/s/{slug}")
        def kb_by_slug(request: Request):
            kbid = self.kbs.resolve_slug(request.params["slug"])
            if kbid is None:
                raise HTTPError(404, "unknown kb slug")
            config = self.kbs.get_config(kbid)
            return KnowledgeBoxObj(uuid=kbid, slug=config.slug if config else "", config=config)

        @r.get("/api/v1/kb/{kbid}")
        def get_kb(request: Request):
            kbid = self._kbid(request)
            config = self.kbs.get_config(kbid)
            return KnowledgeBoxObj(uuid=kbid, slug=config.slug if config else "", config=config)

        @r.patch("/api/v1/kb/{kbid}")
        def update_kb(request: Request):
            """Patch KB title/description/slug (parity: writer PATCH KB)."""
            kbid = self._kbid(request)
            try:
                config = self.kbs.update_config(kbid, request.json() or {})
            except KeyError as e:
                # _kbid already 404s unknown KBs; a KeyError here is a slug
                # conflict (or a delete race, also a conflict)
                raise HTTPError(409, str(e))
            except ValidationError as e:
                raise HTTPError(422, str(e))
            return KnowledgeBoxObj(uuid=kbid, slug=config.slug, config=config)

        @r.delete("/api/v1/kb/{kbid}")
        def delete_kb(request: Request):
            kbid = self._kbid(request)
            self.kbs.delete(kbid)
            return 204, None

        @r.post("/api/v1/kb/{kbid}/vectorsets/{name}")
        def add_vectorset(request: Request):
            kbid = self._kbid(request)
            spec = _validate(VectorSetSpec, request.json())
            self.kbs.add_vectorset(kbid, request.params["name"], spec)
            return 201, {"name": request.params["name"]}

        @r.get("/api/v1/kb/{kbid}/vectorsets")
        def list_vectorsets(request: Request):
            kbid = self._kbid(request)
            config = self.kbs.get_config(kbid)
            return {
                "vectorsets": {
                    name: spec.model_dump()
                    for name, spec in (config.vectorsets if config else {}).items()
                }
            }

        @r.delete("/api/v1/kb/{kbid}/vectorsets/{name}")
        def delete_vectorset(request: Request):
            kbid = self._kbid(request)
            self.kbs.delete_vectorset(kbid, request.params["name"])
            self._sync(force=True)
            return 204, None

        # ---- resources (writer/api/v1/resource.py parity) --------------

        @r.post("/api/v1/kb/{kbid}/resources")
        def create_resource(request: Request):
            kbid = self._kbid(request)
            try:
                self.back_pressure.check_indexing()
            except TryAfterError as e:
                raise HTTPError(429, str(e))
            payload = _validate(CreateResourcePayload, request.json())
            kb_cfg = self.kbs.get_config(kbid)
            if payload.hidden and not (kb_cfg and kb_cfg.hidden_resources_enabled):
                # parity: writer/api/v1/resource.py:102 — hiding requires the
                # KB to enable hidden resources
                raise HTTPError(
                    422,
                    "Cannot hide a resource: the KB does not have hidden resources enabled",
                )
            if (
                kb_cfg is not None
                and kb_cfg.hidden_resources_enabled
                and kb_cfg.hidden_resources_hide_on_creation
                and "hidden" not in (request.json() or {})
            ):
                payload.hidden = True
            for field, value in payload.key_values.items():
                self._check_kv_schema(kbid, field, value)
            # inline b64 file fields: decode before creating (bad base64
            # must 422 without side effects), store blobs after
            # (parity: the reference's push-payload file fields; e2e
            # test_b64_file_upload creates {"files": {...}} resources)
            import base64
            import uuid as _uuid

            # rid is generated HERE so inline file fields can carry their
            # REAL blob key in the persisted payload (a '<rid>' placeholder
            # used to leak to clients and exports as a dangling key)
            rid = _uuid.uuid4().hex
            inline_files: list[tuple[str, str, str, bytes]] = []
            for field, ff in payload.files.items():
                if not ff.file.payload:
                    continue
                try:
                    data = base64.b64decode(ff.file.payload, validate=True)
                except Exception:
                    raise HTTPError(422, f"file field {field!r}: payload must be base64")
                inline_files.append(
                    (field, ff.file.filename or field, ff.file.content_type, data)
                )
                ff.file.payload = None  # blob stored separately, not in KV
                ff.file.key = f"blobs/{kbid}/{rid}/{field}"
                ff.file.size = len(data)
            try:
                rid, seq = self.processor.create_resource(kbid, payload, rid=rid)
            except KeyError as e:
                raise HTTPError(409, str(e))
            for field, filename, content_type, data in inline_files:
                key = f"blobs/{kbid}/{rid}/{field}"
                self.node.storage.put(key, data)
                with self.driver as txn:
                    txn.set(
                        f"/kbs/{kbid}/r/{rid}/files/{field}",
                        json.dumps(
                            {
                                "key": key,
                                "filename": filename,
                                "content_type": content_type,
                                "size": len(data),
                            }
                        ).encode(),
                    )
                _extract_and_index(kbid, rid, field, filename, content_type, data)
            from ..common.audit import AuditType

            self.audit.report(kbid=kbid, audit_type=AuditType.NEW, rid=rid)
            self._notify(kbid, rid, "created", seq)
            return 201, ResourceCreated(uuid=rid, seqid=seq)

        @r.get("/api/v1/kb/{kbid}/resource/{rid}")
        def get_resource(request: Request):
            """GET with `show=` serialization options (parity: reader
            resource serialization, reader/api/v1 `show=basic|values|
            relations|extracted|security`; repeated or comma-separated)."""
            kbid = self._kbid(request)
            rid = request.params["rid"]
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                raise HTTPError(404, f"unknown resource {rid}")
            meta = self.processor.get_meta(kbid, rid)
            show = {
                s.strip() for s in request.query.get("show", "basic,values").split(",")
            }
            out = payload.model_dump()
            out["id"] = rid
            if meta:
                out["created"] = meta.created
                out["modified"] = meta.modified
                # parity: reader serialization's metadata block — clients
                # (and the reference e2e) poll metadata.status == PROCESSED
                out["metadata"] = {"status": meta.status}
            if "values" not in show:
                out.pop("texts", None)
            elif "extracted" not in show and "texts" in out:
                out["texts"] = {
                    fid: t
                    for fid, t in out["texts"].items()
                    if t.get("format") != "EXTRACTED"
                }
            if "relations" not in show and "values" not in show:
                out.pop("usergenerated_relations", None)
            if "security" not in show and "values" not in show:
                out.pop("security", None)
            if "extra" not in show and "values" not in show:
                out.pop("extra", None)
            out.pop("embeddings", None)
            return out

        @r.get("/api/v1/kb/{kbid}/slug/{slug}")
        def get_resource_by_slug(request: Request):
            kbid = self._kbid(request)
            rid = self.processor.resolve_slug(kbid, request.params["slug"])
            if rid is None:
                raise HTTPError(404, "unknown resource slug")
            request.params["rid"] = rid
            return get_resource(request)

        @r.patch("/api/v1/kb/{kbid}/resource/{rid}")
        def update_resource(request: Request):
            kbid = self._kbid(request)
            payload = _validate(UpdateResourcePayload, request.json())
            if payload.hidden:
                kb_cfg = self.kbs.get_config(kbid)
                if not (kb_cfg and kb_cfg.hidden_resources_enabled):
                    raise HTTPError(
                        422,
                        "Cannot hide a resource: the KB does not have hidden resources enabled",
                    )
            for field, value in payload.key_values.items():
                self._check_kv_schema(kbid, field, value)
            seq = self.processor.update_resource(kbid, request.params["rid"], payload)
            from ..common.audit import AuditType

            self.audit.report(
                kbid=kbid, audit_type=AuditType.MODIFIED, rid=request.params["rid"]
            )
            self._notify(kbid, request.params["rid"], "modified", seq)
            return {"seqid": seq}

        @r.delete("/api/v1/kb/{kbid}/resource/{rid}")
        def delete_resource(request: Request):
            kbid = self._kbid(request)
            seq = self.processor.delete_resource(kbid, request.params["rid"])
            if seq is None:
                raise HTTPError(404, "unknown resource")
            from ..common.audit import AuditType

            self.audit.report(
                kbid=kbid, audit_type=AuditType.DELETED, rid=request.params["rid"]
            )
            self._notify(kbid, request.params["rid"], "deleted", seq)
            return 204, None

        # ---- file (blob) fields -------------------------------------------
        # The reference stores extracted blobs in object storage and serves
        # them via the reader's download endpoints (writer/tus uploads,
        # docs/internal/BLOBS.md). Embedded parity: direct binary upload +
        # download; text extraction is the processing service's job and is
        # out of scope for an embedded deployment (file fields index their
        # filename/content-type as metadata).

        def _extract_and_index(
            kbid: str, rid: str, field: str, filename: str, content_type: str,
            data: bytes,
        ) -> bool:
            """Local extraction for text-bearing formats: the extracted text
            becomes a searchable text field (parity: processing-service
            extraction landing as extracted fields; ingest/extract.py)."""
            from ..ingest.extract import extract_text
            from ..models.api import TextFieldPayload, UpdateResourcePayload

            text = extract_text(filename, content_type, data)
            if text is None:
                return False
            current = self.processor.get_payload(kbid, rid)
            texts = dict(current.texts) if current else {}
            texts[field] = TextFieldPayload(
                body=text, format="EXTRACTED",
                # the source file's content type becomes the field's /mt
                # facet (field_mimetype filters)
                mimetype=content_type.partition(";")[0].strip(),
            )
            self.processor.update_resource(
                kbid, rid, UpdateResourcePayload(texts=texts)
            )
            return True

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/file/{field}/upload")
        def upload_file(request: Request):
            kbid = self._kbid(request)
            rid = request.params["rid"]
            if self.processor.get_meta(kbid, rid) is None:
                raise HTTPError(404, "unknown resource")
            field = request.params["field"]
            key = f"blobs/{kbid}/{rid}/{field}"
            self.node.storage.put(key, request.body)
            filename = request.query.get("filename", field)
            content_type = request.headers.get("content-type", "application/octet-stream")
            with self.driver as txn:
                txn.set(
                    f"/kbs/{kbid}/r/{rid}/files/{field}",
                    json.dumps(
                        {
                            "key": key,
                            "filename": filename,
                            "content_type": content_type,
                            "size": len(request.body),
                        }
                    ).encode(),
                )
            extracted = _extract_and_index(
                kbid, rid, field, filename, content_type, request.body
            )
            return 201, {"field": field, "size": len(request.body),
                         "extracted": extracted}

        def _serve_blob(
            request: Request, data: bytes, content_type: str, filename: str = ""
        ):
            """Serve bytes honouring an HTTP Range header (parity:
            reader/api/v1/download.py download_api + parse_media_range —
            single-range 206 with Content-Range, 416 past EOF)."""
            headers = {"Accept-Ranges": "bytes"}
            if filename:
                headers["Content-Disposition"] = f'attachment; filename="{filename}"'
            rng = request.headers.get("range", "")
            if rng.startswith("bytes="):
                spec = rng[len("bytes="):].split(",")[0].strip()
                start_s, _, end_s = spec.partition("-")
                size = len(data)
                try:
                    if start_s == "":  # suffix range: last N bytes
                        start = max(size - int(end_s), 0)
                        end = size - 1
                    else:
                        start = int(start_s)
                        end = min(int(end_s), size - 1) if end_s else size - 1
                except ValueError:
                    raise HTTPError(416, "invalid Range header")
                if start >= size or start > end:
                    raise HTTPError(416, "Range not satisfiable")
                headers["Content-Range"] = f"bytes {start}-{end}/{size}"
                return Response(
                    status=206, body=data[start : end + 1],
                    headers=headers, content_type=content_type,
                )
            return Response(
                status=200, body=data, headers=headers, content_type=content_type
            )

        def download_file(request: Request):
            kbid = self._kbid(request)
            rid = request.params["rid"]
            with self.driver as txn:
                raw = txn.get(f"/kbs/{kbid}/r/{rid}/files/{request.params['field']}")
            if raw is None:
                raise HTTPError(404, "unknown file field")
            info = json.loads(raw)
            return _serve_blob(
                request,
                self.node.storage.get(info["key"]),
                info.get("content_type", "application/octet-stream"),
                info.get("filename", ""),
            )

        r.add("GET", "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/download", download_file)
        # reference path spelling for the same stored-file download
        # (reader/api/v1/download.py download_field_file_rid_prefix)
        r.add("GET", "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/download/field", download_file)

        # ---- TUS resumable uploads (writer/api/v1/upload.py parity) -----

        def _tus_options(request: Request):
            return Response(status=204, headers=dict(TUS_HEADERS))

        for pattern in (
            "/api/v1/kb/{kbid}/tusupload",
            "/api/v1/kb/{kbid}/tusupload/{upload_id}",
            "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload",
            "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload/{upload_id}",
            "/api/v1/kb/{kbid}/slug/{rslug}/file/{field}/tusupload",
            "/api/v1/kb/{kbid}/slug/{rslug}/file/{field}/tusupload/{upload_id}",
        ):
            r.add("OPTIONS", pattern, _tus_options)

        def _tus_validate(request: Request) -> tuple[int, dict]:
            """TUS header validation, side-effect free — callers that create
            state first (KB-level implicit resource) validate BEFORE it."""
            size = -1
            if "upload-length" in request.headers:
                try:
                    size = int(request.headers["upload-length"])
                except ValueError:
                    raise HTTPError(400, "invalid Upload-Length")
            elif request.headers.get("upload-defer-length") != "1":
                raise HTTPError(400, "Upload-Length or Upload-Defer-Length: 1 required")
            try:
                metadata = parse_upload_metadata(
                    request.headers.get("upload-metadata", "")
                )
            except TusError as e:
                raise HTTPError(e.status, e.detail)
            return size, metadata

        def _tus_create(request: Request, kbid: str, rid: str, field: str,
                        deterministic: bool) -> Response:
            size, metadata = _tus_validate(request)
            session = self.tus.create(
                kbid, rid, field, size=size, metadata=metadata,
                deterministic=deterministic,
            )
            location = f"{request.path.rstrip('/')}/{session.upload_id}"
            return Response(
                status=201,
                headers={
                    "Location": location,
                    "Tus-Resumable": "1.0.0",
                    "Access-Control-Expose-Headers": "Location,Tus-Resumable",
                },
            )

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload")
        def tus_post_field(request: Request):
            kbid = self._kbid(request)
            rid = request.params["rid"]
            if self.processor.get_meta(kbid, rid) is None:
                raise HTTPError(404, "unknown resource")
            return _tus_create(request, kbid, rid, request.params["field"],
                               deterministic=True)

        @r.post("/api/v1/kb/{kbid}/slug/{rslug}/file/{field}/tusupload")
        def tus_post_field_by_slug(request: Request):
            kbid = self._kbid(request)
            rid = self.processor.resolve_slug(kbid, request.params["rslug"])
            if rid is None:
                raise HTTPError(404, "unknown resource slug")
            return _tus_create(request, kbid, rid, request.params["field"],
                               deterministic=True)

        @r.post("/api/v1/kb/{kbid}/tusupload")
        def tus_post_kb(request: Request):
            """KB-level TUS: implicitly creates the resource the upload
            lands on (parity: upload.py tus_post → store_file_on_nuclia_db)."""
            kbid = self._kbid(request)
            _tus_validate(request)  # bad TUS headers must not orphan a resource
            item = request.json() if request.body else {}
            payload = _validate(CreateResourcePayload, item or {})
            if not payload.title:
                payload.title = "Upload"
            try:
                rid, seq = self.processor.create_resource(kbid, payload)
            except KeyError as e:
                raise HTTPError(409, str(e))
            self._notify(kbid, rid, "created", seq)
            resp = _tus_create(request, kbid, rid, "file", deterministic=False)
            resp.headers["NDB-Resource"] = f"/kb/{kbid}/resource/{rid}"
            return resp

        def _tus_head(request: Request):
            kbid = self._kbid(request)
            try:
                session = self.tus.get(kbid, request.params["upload_id"])
            except TusError as e:
                raise HTTPError(e.status, e.detail)
            headers = {
                "Tus-Resumable": "1.0.0",
                "Upload-Offset": str(session.offset),
                "Access-Control-Expose-Headers":
                    "Upload-Offset,Tus-Resumable,Upload-Length,Upload-Defer-Length",
            }
            if session.size >= 0:
                headers["Upload-Length"] = str(session.size)
            else:
                # TUS 1.0: while the length is deferred, Upload-Length MUST
                # be omitted ("0" would read as a complete/corrupt upload)
                headers["Upload-Defer-Length"] = "1"
            return Response(status=200, headers=headers)

        def _tus_patch(request: Request):
            kbid = self._kbid(request)
            try:
                offset = int(request.headers.get("upload-offset", 0))
                declared = (
                    int(request.headers["upload-length"])
                    if "upload-length" in request.headers
                    else None
                )
                session, finished = self.tus.patch(
                    kbid, request.params["upload_id"], offset, request.body,
                    declared_size=declared,
                )
            except TusError as e:
                raise HTTPError(e.status, e.detail)
            headers = {
                "Tus-Resumable": "1.0.0",
                "Upload-Offset": str(session.offset),
                "Access-Control-Expose-Headers":
                    "Upload-Offset,Tus-Resumable,Tus-Upload-Finished",
            }
            if finished:
                headers["Tus-Upload-Finished"] = "1"
                # extraction loads the blob into memory — skip huge uploads
                # (text-bearing documents are small; multi-GB blobs are media)
                if session.offset <= _EXTRACT_MAX_BYTES:
                    blob = self.node.storage.get(
                        f"blobs/{kbid}/{session.rid}/{session.field}"
                    )
                    _extract_and_index(
                        kbid, session.rid, session.field, session.filename,
                        session.content_type, blob,
                    )
                else:
                    logger.warning(
                        "tus upload %s/%s/%s (%d bytes) exceeds the %d-byte "
                        "extraction cap; stored but not text-indexed",
                        kbid, session.rid, session.field, session.offset,
                        _EXTRACT_MAX_BYTES,
                    )
                self._notify(kbid, session.rid, "modified", None)
            return Response(status=204, headers=headers)

        for pattern in (
            "/api/v1/kb/{kbid}/tusupload/{upload_id}",
            "/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload/{upload_id}",
            # slug-form creation returns a slug-form Location; PATCH/HEAD
            # must resolve against it or the upload can never proceed
            "/api/v1/kb/{kbid}/slug/{rslug}/file/{field}/tusupload/{upload_id}",
        ):
            r.add("HEAD", pattern, _tus_head)
            r.add("PATCH", pattern, _tus_patch)

        # ---- typed field CRUD (text / link / conversation) ---------------
        # parity: writer/api/v1 field.py per-field routes + reader field GET

        def _put_field(kbid: str, rid: str, kind: str, field: str, value) -> None:
            from ..models.api import UpdateResourcePayload

            current = self.processor.get_payload(kbid, rid)
            if current is None:
                raise HTTPError(404, "unknown resource")
            coll = dict(getattr(current, kind))
            if value is None:
                if field not in coll:
                    raise HTTPError(404, f"unknown {kind} field {field}")
                del coll[field]
            else:
                coll[field] = value
            seq = self.processor.update_resource(
                kbid, rid, UpdateResourcePayload(**{kind: coll})
            )
            self._notify(kbid, rid, "modified", seq)

        def _store_conv_attachments(kbid: str, rid: str, field: str, conv):
            """Persist b64 message attachments to blob storage, replacing the
            inline payload with its storage key (parity: conversation fields
            carrying CloudFile attachments; reference stores the file and
            serves it via the conversation download route)."""
            import base64

            for mi, msg in enumerate(conv.messages):
                for fi, att in enumerate(msg.files):
                    if att.payload is None:
                        continue
                    try:
                        data = base64.b64decode(att.payload)
                    except Exception:
                        raise HTTPError(422, "attachment payload must be base64")
                    ident = msg.ident or str(mi)
                    key = f"blobs/{kbid}/{rid}/conv/{field}/{ident}/{fi}"
                    self.node.storage.put(key, data)
                    att.payload = None
                    att.key = key
                    att.size = len(data)
            return conv

        def _field_routes(kind: str, model):
            def put_field(request: Request):
                kbid = self._kbid(request)
                rid = request.params["rid"]
                body = request.json()
                value = _validate(model, body) if model is not None else body
                if model is None:
                    if not isinstance(value, dict):
                        raise HTTPError(422, "key_value field body must be an object")
                    self._check_kv_schema(kbid, request.params["field"], value)
                if kind == "conversations":
                    value = _store_conv_attachments(
                        kbid, rid, request.params["field"], value
                    )
                _put_field(kbid, rid, kind, request.params["field"], value)
                return 201, {"ok": True}

            def get_field(request: Request):
                kbid = self._kbid(request)
                payload = self.processor.get_payload(kbid, request.params["rid"])
                coll = getattr(payload, kind) if payload else {}
                field = request.params["field"]
                if field not in coll:
                    raise HTTPError(404, f"unknown {kind} field {field}")
                return coll[field]

            def delete_field(request: Request):
                kbid = self._kbid(request)
                _put_field(kbid, request.params["rid"], kind, request.params["field"], None)
                return 204, None

            singular = {
                "texts": "text", "links": "link",
                "conversations": "conversation", "key_values": "key_value",
            }[kind]
            pattern = "/api/v1/kb/{kbid}/resource/{rid}/" + singular + "/{field}"
            r.add("PUT", pattern, put_field)
            r.add("GET", pattern, get_field)
            r.add("DELETE", pattern, delete_field)

        from ..models.api import (
            ConversationFieldPayload,
            ConversationMessage,
            LinkFieldPayload,
            TextFieldPayload,
        )

        _field_routes("texts", TextFieldPayload)
        _field_routes("links", LinkFieldPayload)
        _field_routes("conversations", ConversationFieldPayload)
        _field_routes("key_values", None)

        @r.put("/api/v1/kb/{kbid}/resource/{rid}/conversation/{field}/messages")
        def append_messages(request: Request):
            """Append messages to a conversation field (parity: writer
            conversation messages route)."""
            kbid = self._kbid(request)
            rid = request.params["rid"]
            field = request.params["field"]
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                raise HTTPError(404, "unknown resource")
            conv = payload.conversations.get(field) or ConversationFieldPayload()
            new = [
                _validate(ConversationMessage, m) for m in (request.json() or [])
            ]
            conv = ConversationFieldPayload(messages=list(conv.messages) + new)
            conv = _store_conv_attachments(kbid, rid, field, conv)
            _put_field(kbid, rid, "conversations", field, conv)
            return 200, {"messages": len(conv.messages)}

        @r.get("/api/v1/kb/{kbid}/resource/{rid}/conversation/{field}/download/field/{message_id}/{file_num}")
        def download_conv_attachment(request: Request):
            """Serve one message attachment (parity: reader download.py
            download_field_conversation_attachment_rid_prefix)."""
            kbid = self._kbid(request)
            payload = self.processor.get_payload(kbid, request.params["rid"])
            conv = (payload.conversations if payload else {}).get(request.params["field"])
            if conv is None:
                raise HTTPError(404, "unknown conversation field")
            mid = request.params["message_id"]
            msg = next((m for m in conv.messages if m.ident == mid), None)
            if msg is None:
                try:
                    msg = conv.messages[int(mid)]
                except (ValueError, IndexError):
                    raise HTTPError(404, "unknown message")
            try:
                att = msg.files[int(request.params["file_num"])]
            except (ValueError, IndexError):
                raise HTTPError(404, "unknown attachment")
            if not att.key:
                raise HTTPError(404, "attachment has no stored content")
            return _serve_blob(
                request, self.node.storage.get(att.key),
                att.content_type, att.filename,
            )

        @r.get("/api/v1/kb/{kbid}/resource/{rid}/conversation/{field}/messages")
        def get_messages(request: Request):
            kbid = self._kbid(request)
            payload = self.processor.get_payload(kbid, request.params["rid"])
            conv = (payload.conversations if payload else {}).get(request.params["field"])
            if conv is None:
                raise HTTPError(404, "unknown conversation field")
            page = int(request.query.get("page", 0))
            size = int(request.query.get("size", 50))
            msgs = conv.messages[page * size : (page + 1) * size]
            return {
                "messages": [m.model_dump() for m in msgs],
                "total": len(conv.messages),
            }

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/reindex")
        def reindex_resource(request: Request):
            """Rebuild the brain from the stored payload and re-index
            (parity: writer reindex route)."""
            from ..models.api import UpdateResourcePayload

            kbid = self._kbid(request)
            rid = request.params["rid"]
            if self.processor.get_meta(kbid, rid) is None:
                raise HTTPError(404, "unknown resource")
            seq = self.processor.update_resource(kbid, rid, UpdateResourcePayload())
            return 200, {"seqid": int(seq)}

        r.add("POST", "/api/v1/kb/{kbid}/resource/{rid}/reprocess", reindex_resource)

        @r.get("/api/v1/kb/{kbid}/resource/{rid}/files")
        def list_files(request: Request):
            kbid = self._kbid(request)
            rid = request.params["rid"]
            prefix = f"/kbs/{kbid}/r/{rid}/files/"
            with self.driver as txn:
                out = {}
                for key in txn.keys(prefix):
                    raw = txn.get(key)
                    if raw:
                        info = json.loads(raw)
                        info.pop("key", None)
                        out[key[len(prefix):]] = info
            return {"files": out}

        def _drain_notifications(kbid: str, since: int, limit: int) -> list[dict]:
            """Repeatable cursor read: the same `since` re-delivers (a
            consumer-based drain would ack and starve repeated polls)."""
            out = []
            for msg in self.bus.scan(
                "ndb_notify",
                subject_prefix=f"notify.{kbid}",
                after_seq=since,
                limit=limit,
            ):
                event = json.loads(msg.payload)
                event["seq_cursor"] = msg.seq
                out.append(event)
            return out

        @r.get("/api/v1/kb/{kbid}/notifications")
        def notifications(request: Request):
            """Activity events. Default: cursor-paginated JSON by bus seq.
            With `Accept: text/event-stream` (or ?stream=sse): a live SSE
            stream that tails the KB's notify subject for up to `timeout`
            seconds then closes (parity: reader notifications SSE endpoint,
            reference reader/api/v1/knowledgebox.py notifications)."""
            kbid = self._kbid(request)
            since = int(request.query.get("since", 0))
            limit = int(request.query.get("limit", 100))
            wants_sse = (
                "text/event-stream" in request.headers.get("accept", "")
                or request.query.get("stream") == "sse"
            )
            if not wants_sse:
                return {"notifications": _drain_notifications(kbid, since, limit)}

            timeout = min(float(request.query.get("timeout", 30.0)), 300.0)

            def sse_events():
                deadline = time.time() + timeout
                cursor = since
                sent = 0
                while time.time() < deadline and sent < limit:
                    events = _drain_notifications(kbid, cursor, limit - sent)
                    for event in events:
                        cursor = max(cursor, event["seq_cursor"])
                        sent += 1
                        yield f"data: {json.dumps(event)}\n\n"
                    if not events:
                        # comment frame keeps intermediaries from idling out;
                        # the sleep happens on the event loop (Pace), not on
                        # a shared executor worker
                        yield ": keep-alive\n\n"
                        yield Pace(0.2)

            return StreamingResponse(sse_events(), content_type="text/event-stream")

        @r.get("/api/v1/kb/{kbid}/resources")
        def list_resources(request: Request):
            """Paginated resource listing with basic serialization (parity:
            reader KB resource list — ResourceList{resources, pagination})."""
            kbid = self._kbid(request)
            page = int(request.query.get("page", 0))
            size = int(request.query.get("size", 20))
            rids = self.processor.list_resources(kbid)
            window = rids[page * size : (page + 1) * size]
            out = []
            for rid in window:
                meta = self.processor.get_meta(kbid, rid)
                payload = self.processor.get_payload(kbid, rid)
                out.append(
                    {
                        "id": rid,
                        "slug": meta.slug if meta else "",
                        "title": payload.title if payload else "",
                    }
                )
            return {
                "resources": out,
                "pagination": {
                    "page": page,
                    "size": size,
                    "last": (page + 1) * size >= len(rids),
                },
            }

        # ---- search (search/api/v1 parity) -------------------------------

        @r.post("/api/v1/kb/{kbid}/predict/{endpoint}")
        def predict_proxy(request: Request):
            """Predict passthrough (parity: /predict/{endpoint} proxying to
            the learning backend). Embedded serving routes `sentence` and
            `chat` to the configured PredictEngine; other endpoints need an
            external learning deployment (412, like the reference without
            NUA)."""
            kbid = self._kbid(request)
            engine = self.search.predict
            if engine is None:
                raise HTTPError(412, "no predict engine configured")
            body = request.json() or {}
            endpoint = request.params["endpoint"]
            if endpoint == "sentence":
                vec = engine.embed(
                    kbid, body.get("vectorset", ""), body.get("text", "")
                )
                if vec is None:
                    raise HTTPError(412, "predict engine cannot embed")
                return {"data": [float(x) for x in vec]}
            if endpoint == "chat":
                answer = engine.generate(
                    kbid, body.get("question", ""), body.get("context", [])
                )
                return {"answer": answer}
            if endpoint == "rerank" and hasattr(engine, "rerank"):
                return {
                    "scores": engine.rerank(
                        kbid, body.get("query", ""), body.get("passages", [])
                    )
                }
            if endpoint == "rephrase" and hasattr(engine, "rephrase"):
                return {
                    "rephrased": engine.rephrase(
                        kbid, body.get("query", ""), body.get("chat_history", [])
                    )
                }
            if endpoint == "tokens" and hasattr(engine, "detect_entities"):
                return {"entities": engine.detect_entities(kbid, body.get("text", ""))}
            if endpoint == "summarize" and hasattr(engine, "summarize"):
                return {"summary": engine.summarize(kbid, body.get("texts", []))}
            raise HTTPError(404, f"unknown predict endpoint {endpoint}")

        @r.get("/api/v1/kb/{kbid}/models")
        def list_models(request: Request):
            """Trained-model listing (parity: /models — embedded deployments
            have no trained models unless a learning backend is attached)."""
            self._kbid(request)
            return {"models": []}

        @r.post("/api/v1/kb/{kbid}/hydrate")
        def hydrate(request: Request):
            """Resolve paragraph/field ids to their text (parity: /hydrate —
            the batch hydration endpoint for agent workflows)."""
            kbid = self._kbid(request)
            body = request.json() or {}
            out: dict[str, Optional[str]] = {}
            for pid in body.get("paragraphs", []):
                from ..search.find import parse_paragraph_id

                parsed = parse_paragraph_id(pid)
                if parsed is None:
                    out[pid] = None
                    continue
                rid, fid, start, end = parsed
                text = self.processor.field_text(kbid, rid, fid)
                out[pid] = text[start:end] if text else None
            for fid_full in body.get("fields", []):
                rid, _, fid = fid_full.partition("/")
                out[fid_full] = self.processor.field_text(kbid, rid, fid)
            return {"texts": out}

        @r.get("/api/v1/kb/{kbid}/processing-status")
        def processing_status(request: Request):
            """Per-resource processing status (parity: /processing-status —
            embedded ingestion is synchronous, so resources are PROCESSED
            the moment they exist)."""
            kbid = self._kbid(request)
            cursor = request.query.get("cursor", "")
            limit = int(request.query.get("limit", 20))
            rids = [
                rid for rid in self.processor.list_resources(kbid) if rid > cursor
            ][:limit]
            results = []
            for rid in rids:
                meta = self.processor.get_meta(kbid, rid)
                if meta is None:
                    continue
                results.append(
                    {"resource_id": rid, "completed": True,
                     "status": meta.status, "modified": meta.modified}
                )
            return {
                "results": results,
                "cursor": rids[-1] if len(rids) == limit else None,
            }

        # ---- kv-schemas: JSON schemas validating key_value fields ---------
        # parity: /kv-schemas CRUD; stored schemas validate key_value field
        # writes whose field name matches the schema id

        KV_SCHEMA_KEY = "/kbs/{kbid}/kv_schemas/{sid}"

        @r.get("/api/v1/kb/{kbid}/kv-schemas")
        def list_kv_schemas(request: Request):
            kbid = self._kbid(request)
            prefix = KV_SCHEMA_KEY.format(kbid=kbid, sid="")
            with self.driver as txn:
                return {
                    "schemas": {
                        key[len(prefix):]: json.loads(txn.get(key) or b"{}")
                        for key in txn.keys(prefix)
                    }
                }

        @r.post("/api/v1/kb/{kbid}/kv-schemas/{sid}")
        def set_kv_schema(request: Request):
            from ..utils.jsonschema import validate_schema

            kbid = self._kbid(request)
            schema = request.json()
            try:
                validate_schema(schema)
            except ValueError as e:
                raise HTTPError(422, f"invalid schema: {e}")
            with self.driver as txn:
                txn.set(
                    KV_SCHEMA_KEY.format(kbid=kbid, sid=request.params["sid"]),
                    json.dumps(schema).encode(),
                )
            return 201, {"ok": True}

        @r.delete("/api/v1/kb/{kbid}/kv-schemas/{sid}")
        def delete_kv_schema(request: Request):
            kbid = self._kbid(request)
            with self.driver as txn:
                txn.delete(KV_SCHEMA_KEY.format(kbid=kbid, sid=request.params["sid"]))
            return 204, None

        def _check_kv_schema(kbid: str, field: str, value: dict) -> None:
            from ..utils.jsonschema import validate_instance

            with self.driver as txn:
                raw = txn.get(KV_SCHEMA_KEY.format(kbid=kbid, sid=field))
            if raw is None:
                return
            try:
                validate_instance(value, json.loads(raw))
            except ValueError as e:
                raise HTTPError(422, f"key_value does not match schema: {e}")

        self._check_kv_schema = _check_kv_schema

        # ---- search configurations (saved request presets) ----------------
        # parity: /search_configurations CRUD + `search_configuration` name
        # in find/ask bodies (reference search_configurations.py): the saved
        # config supplies defaults, the request's own keys win.

        SEARCH_CONFIG_KEY = "/kbs/{kbid}/search_configurations/{name}"

        @r.get("/api/v1/kb/{kbid}/search_configurations")
        def list_search_configs(request: Request):
            kbid = self._kbid(request)
            prefix = SEARCH_CONFIG_KEY.format(kbid=kbid, name="")
            out = {}
            with self.driver as txn:
                for key in txn.keys(prefix):
                    raw = txn.get(key)
                    if raw:
                        out[key[len(prefix):]] = json.loads(raw)
            return out

        @r.get("/api/v1/kb/{kbid}/search_configurations/{name}")
        def get_search_config(request: Request):
            kbid = self._kbid(request)
            with self.driver as txn:
                raw = txn.get(
                    SEARCH_CONFIG_KEY.format(kbid=kbid, name=request.params["name"])
                )
            if raw is None:
                raise HTTPError(404, "unknown search configuration")
            return json.loads(raw)

        def set_search_config(request: Request):
            kbid = self._kbid(request)
            body = request.json()
            if not isinstance(body, dict):
                raise HTTPError(422, "search configuration must be an object")
            _validate(FindRequest, {k: v for k, v in body.items() if k != "kind"})
            with self.driver as txn:
                txn.set(
                    SEARCH_CONFIG_KEY.format(kbid=kbid, name=request.params["name"]),
                    json.dumps(body).encode(),
                )
            return 201, {"ok": True}

        r.add("POST", "/api/v1/kb/{kbid}/search_configurations/{name}", set_search_config)
        r.add("PATCH", "/api/v1/kb/{kbid}/search_configurations/{name}", set_search_config)

        @r.delete("/api/v1/kb/{kbid}/search_configurations/{name}")
        def delete_search_config(request: Request):
            kbid = self._kbid(request)
            with self.driver as txn:
                txn.delete(
                    SEARCH_CONFIG_KEY.format(kbid=kbid, name=request.params["name"])
                )
            return 204, None

        def _apply_search_config(kbid: str, body: dict) -> dict:
            name = body.pop("search_configuration", None)
            if not name:
                return body
            with self.driver as txn:
                raw = txn.get(SEARCH_CONFIG_KEY.format(kbid=kbid, name=name))
            if raw is None:
                raise HTTPError(422, f"unknown search configuration {name!r}")
            config = {k: v for k, v in json.loads(raw).items() if k != "kind"}
            return {**config, **body}

        def _audit_ctx(request: Request) -> tuple[str, str]:
            # parity: X-NUCLIADB-USER / X-NDB-CLIENT headers on every
            # search/chat audit report (audit/stream.py)
            return (
                request.headers.get("x-nucliadb-user", ""),
                request.headers.get("x-ndb-client", ""),
            )

        @r.post("/api/v1/kb/{kbid}/find")
        def find(request: Request):
            kbid = self._kbid(request)
            req = _validate(FindRequest, _apply_search_config(kbid, request.json()))
            self._sync()
            t0 = time.monotonic()
            results = self.search.find(kbid, req)
            user, client = _audit_ctx(request)
            self.audit.search(
                kbid, req.query, len(results.best_matches), user=user,
                client_type=client, duration_ms=(time.monotonic() - t0) * 1e3,
            )
            return results

        @r.get("/api/v1/kb/{kbid}/find")
        def find_get(request: Request):
            # query-param spelling of the POST body (parity: the reference
            # registers GET variants with fastapi_query params; repeated
            # params arrive comma-joined from the router)
            kbid = self._kbid(request)
            q = request.query

            def _list(name):
                raw = q.get(name, "")
                return [v for v in raw.split(",") if v] if raw else []

            body: dict = {"query": q.get("query", "")}
            for name in ("top_k", "offset"):
                if name in q:
                    body[name] = int(q[name])
            for name in ("highlight", "autofilter", "show_hidden", "with_synonyms",
                         "with_duplicates"):
                if name in q:
                    body[name] = q[name].lower() in ("1", "true", "yes")
            for name in ("min_score_semantic", "min_score_bm25"):
                if name in q:
                    body[name] = float(q[name])
            if "min_score" in q:
                body["min_score"] = float(q["min_score"])
            for name in ("features", "filters", "fields", "resource_filters",
                         "faceted", "show", "security_groups"):
                vals = _list(name)
                if vals:
                    body[name] = vals
            for name in ("vectorset", "rank_fusion", "reranker", "sort_field",
                         "sort_order", "search_after",
                         "range_creation_start", "range_creation_end",
                         "range_modification_start", "range_modification_end"):
                if name in q:
                    body[name] = q[name]
            req = _validate(FindRequest, body)
            self._sync()
            return self.search.find(kbid, req)

        @r.post("/api/v1/kb/{kbid}/search")
        def search_post(request: Request):
            # legacy /search maps onto the same retrieval pipeline
            return find(request)

        @r.get("/api/v1/kb/{kbid}/search")
        def search_get(request: Request):
            # parity: search/api/v1/search.py registers GET alongside POST
            return find_get(request)

        @r.post("/api/v1/kb/{kbid}/suggest")
        def suggest(request: Request):
            kbid = self._kbid(request)
            req = _validate(SuggestRequest, request.json())
            self._sync()
            t0 = time.monotonic()
            results = self.search.suggest(kbid, req)
            user, client = _audit_ctx(request)
            self.audit.suggest(
                kbid, req.query, user=user, client_type=client,
                duration_ms=(time.monotonic() - t0) * 1e3,
            )
            return results

        @r.get("/api/v1/kb/{kbid}/suggest")
        def suggest_get(request: Request):
            kbid = self._kbid(request)
            q = request.query
            body: dict = {"query": q.get("query", "")}
            if "top_k" in q:
                body["top_k"] = int(q["top_k"])
            for name in ("features", "filters"):
                raw = q.get(name, "")
                if raw:
                    body[name] = [v for v in raw.split(",") if v]
            req = _validate(SuggestRequest, body)
            self._sync()
            return self.search.suggest(kbid, req)

        @r.post("/api/v1/kb/{kbid}/catalog")
        def catalog(request: Request):
            kbid = self._kbid(request)
            req = _validate(CatalogRequest, request.json())
            self._sync()
            return self.search.catalog(kbid, req)

        @r.get("/api/v1/kb/{kbid}/catalog")
        def catalog_get(request: Request):
            # parity: catalog.py registers GET alongside POST
            kbid = self._kbid(request)
            q = request.query
            body: dict = {"query": q.get("query", "")}
            for name in ("page_number", "page_size"):
                if name in q:
                    body[name] = int(q[name])
            for name in ("faceted", "filters"):
                raw = q.get(name, "")
                if raw:
                    body[name] = [v for v in raw.split(",") if v]
            for name in ("order_by", "range_creation_start", "range_creation_end",
                         "range_modification_start", "range_modification_end"):
                if name in q:
                    body[name] = q[name]
            if "hidden" in q:
                body["hidden"] = q["hidden"].lower() in ("1", "true", "yes")
            req = _validate(CatalogRequest, body)
            self._sync()
            return self.search.catalog(kbid, req)

        @r.post("/api/v1/kb/{kbid}/catalog/facets")
        def catalog_facets(request: Request):
            """Facet distribution only (parity: /catalog/facets)."""
            kbid = self._kbid(request)
            body = request.json() or {}
            prefixes = body.get("prefixes", body.get("faceted", []))
            if prefixes and isinstance(prefixes[0], dict):
                prefixes = [p.get("prefix", "") for p in prefixes]
            req = CatalogRequest(faceted=prefixes, page_size=0)
            self._sync()
            return {"facets": self.search.catalog(kbid, req).facets}

        @r.get("/api/v1/kb/{kbid}/counters")
        def counters(request: Request):
            """KB counters (parity: /counters — resources/fields/paragraphs/
            sentences; the reference reads shard stats, here from payloads)."""
            from ..ingest.brain import split_paragraphs

            kbid = self._kbid(request)
            rids = self.processor.list_resources(kbid)
            # count from the KV listing (the source of truth) — the cached
            # per-shard counters can drift by a few under rollover races
            # (observed in the soak) and this endpoint walks the payloads
            # anyway
            resources = len(rids)
            fields = paragraphs = sentences = 0
            for rid in rids:
                payload = self.processor.get_payload(kbid, rid)
                if payload is None:
                    continue
                texts = [t.body for t in payload.texts.values()]
                if payload.title:
                    texts.append(payload.title)
                if payload.summary:
                    texts.append(payload.summary)
                fields += len(texts) + len(payload.links) + len(payload.conversations)
                # conversations index one paragraph per message (brain.py)
                for conv in payload.conversations.values():
                    paragraphs += len(conv.messages)
                    sentences += len(conv.messages)
                for text in texts:
                    spans = list(split_paragraphs(text))
                    paragraphs += len(spans)
                    sentences += sum(
                        max(text[s:e].count(". ") + 1, 1) for s, e in spans
                    )
            return {
                "resources": resources,
                "fields": fields,
                "paragraphs": paragraphs,
                "sentences": sentences,
            }

        @r.post("/api/v1/kb/{kbid}/feedback")
        def feedback(request: Request):
            """User feedback on search/ask results -> audit stream (parity:
            search/api/v1/feedback.py sending AuditEffect to the stream)."""
            kbid = self._kbid(request)
            body = request.json() or {}
            if "ident" not in body:
                raise HTTPError(422, "feedback requires an 'ident'")
            self.bus.publish(
                "ndb_audit",
                f"feedback.{kbid}",
                json.dumps({"kbid": kbid, **body, "when": time.time()}).encode(),
            )
            return 204, None

        @r.post("/api/v1/kb/{kbid}/summarize")
        def summarize(request: Request):
            """Resource summaries (parity: /summarize through Predict; the
            embedded fallback is extractive — leading sentences per field)."""
            kbid = self._kbid(request)
            body = request.json() or {}
            rids = body.get("resources", [])
            if not rids:
                raise HTTPError(422, "summarize requires 'resources'")
            out = {}
            for ref in rids:
                rid = self.processor.resolve_slug(kbid, ref) or ref
                payload = self.processor.get_payload(kbid, rid)
                if payload is None:
                    out[ref] = {"summary": "", "error": "not found"}
                    continue
                text = "\n".join(t.body for t in payload.texts.values())[:4000]
                if self.search.predict is not None:
                    summary = self.search.predict.generate(
                        kbid, f"Summarize:\n{text}", []
                    )
                else:
                    import re as _re

                    sentences = _re.findall(r"[^.!?\n]+[.!?]?", text)
                    summary = " ".join(s.strip() for s in sentences[:3])
                out[ref] = {"summary": summary}
            return {
                "resources": out,
                "summary": "\n".join(v["summary"] for v in out.values()),
            }

        def _graph_filter(body: dict):
            from ..models.api import FilterExpression as FE

            fe = body.get("filter_expression")
            if not fe:
                return None
            # back-compat: a LEGACY label tree wrapped reference-style as
            # {"field": {...}} unwraps; rich trees ({"field": {"prop"/and/
            # or/not atoms}}) flow through whole (search/filter_expr.py)
            fld = fe.get("field") if isinstance(fe, dict) else None
            if isinstance(fld, dict) and (
                {"literal", "all", "any", "none", "not"} & set(fld)
            ):
                return _validate(FE, fld)
            return _validate(FE, fe)

        def _graph_security(body: dict):
            sec = body.get("security")
            if not sec:
                return None
            return list(sec.get("groups", []) or [])

        @r.post("/api/v1/kb/{kbid}/graph")
        def graph(request: Request):
            kbid = self._kbid(request)
            body = request.json() or {}
            self._sync()
            if isinstance(body.get("query"), dict):
                # reference-style boolean path-query expression
                # (and/or/not over path/node/relation leaves)
                try:
                    return self.search.graph_expr(
                        kbid,
                        body["query"],
                        int(body.get("top_k", 50)),
                        filter_expression=_graph_filter(body),
                        security_groups=_graph_security(body),
                        show_hidden=bool(body.get("show_hidden", False)),
                    )
                except ValueError as e:
                    raise HTTPError(422, str(e))
            req = _validate(GraphSearchPayload, body)
            return self.search.graph(kbid, req)

        def _graph_paths(kbid: str, body: dict):
            """Shared path resolution for the node/relation projections:
            dict queries are boolean expressions, flat payloads the classic
            single-hop pattern."""
            if isinstance(body.get("query"), dict):
                try:
                    return self.search.graph_expr(
                        kbid,
                        body["query"],
                        int(body.get("top_k", 50)),
                        filter_expression=_graph_filter(body),
                        security_groups=_graph_security(body),
                        show_hidden=bool(body.get("show_hidden", False)),
                    )
                except ValueError as e:
                    raise HTTPError(422, str(e))
            return self.search.graph(kbid, _validate(GraphSearchPayload, body))

        @r.post("/api/v1/kb/{kbid}/graph/nodes")
        def graph_nodes(request: Request):
            """Distinct node search (parity: /graph/nodes — the node query
            evaluated at source AND destination positions, unique nodes with
            best score; nidx_relation/src/reader.rs nodes_graph_search)."""
            kbid = self._kbid(request)
            self._sync()
            body = request.json() or {}
            if isinstance(body.get("query"), dict):
                try:
                    return self.search.graph_nodes_expr(
                        kbid,
                        body["query"],
                        int(body.get("top_k", 50)),
                        filter_expression=_graph_filter(body),
                        security_groups=_graph_security(body),
                        show_hidden=bool(body.get("show_hidden", False)),
                    )
                except ValueError as e:
                    raise HTTPError(422, str(e))
            out = _graph_paths(kbid, body)
            seen = {}
            for p in out.paths:
                for value, ntype, group in (
                    (p.source, p.source_type, p.source_group),
                    (p.target, p.target_type, p.target_group),
                ):
                    if value:
                        seen.setdefault(
                            (value, ntype),
                            {"value": value, "type": ntype, "group": group},
                        )
            return {"nodes": list(seen.values())}

        @r.post("/api/v1/kb/{kbid}/graph/relations")
        def graph_relations(request: Request):
            """Distinct relation search (parity: /graph/relations — unique
            (type, label) pairs with best score; relations_graph_search)."""
            kbid = self._kbid(request)
            self._sync()
            body = request.json() or {}
            if isinstance(body.get("query"), dict):
                try:
                    return self.search.graph_relations_expr(
                        kbid,
                        body["query"],
                        int(body.get("top_k", 50)),
                        filter_expression=_graph_filter(body),
                        security_groups=_graph_security(body),
                        show_hidden=bool(body.get("show_hidden", False)),
                    )
                except ValueError as e:
                    raise HTTPError(422, str(e))
            out = _graph_paths(kbid, body)
            seen = {}
            for p in out.paths:
                seen.setdefault((p.relation, p.label), {"relation": p.relation, "label": p.label})
            return {"relations": list(seen.values())}

        def _is_sync_ask(request: Request) -> bool:
            # reference default (search/api/v1/ask.py x_synchronous=False):
            # the ndjson item stream UNLESS the caller opts into sync JSON
            return request.headers.get("x-synchronous", "").lower() in (
                "true", "1", "yes",
            )

        def _run_ask(request: Request, kbid: str, req):
            """Shared /ask execution + response shaping: synchronous JSON, or
            the ndjson item stream with answer chunks flushed AS the predict
            engine produces them (parity: AskResponseItems — retrieval,
            answer chunks, citations, status; the reference streams Predict
            /chat tokens, chat/ask.py:210-370). Audit fires once the answer
            is complete (stream end)."""
            t0 = time.monotonic()
            user, client = _audit_ctx(request)

            def audit(answer: str, status: str):
                self.audit.chat(
                    kbid, req.query, answer, status=status,
                    user=user, client_type=client,
                    duration_ms=(time.monotonic() - t0) * 1e3,
                )

            if _is_sync_ask(request):
                result = self.search.ask(kbid, req)
                audit(result.answer, result.status)
                return result

            head, chunks = self.search.ask_stream(kbid, req)

            def ndjson_items():
                if head.retrieval is not None:
                    yield json.dumps(
                        {"item": {"type": "retrieval",
                                  "results": json.loads(head.retrieval.model_dump_json())}}
                    ) + "\n"
                parts: list[str] = []
                for chunk in chunks:  # flushed per chunk, as produced
                    parts.append(chunk)
                    yield json.dumps(
                        {"item": {"type": "answer", "text": chunk}}
                    ) + "\n"
                head.answer = "".join(parts)
                yield json.dumps(
                    {"item": {"type": "citations", "citations": head.citations}}
                ) + "\n"
                yield json.dumps({"item": {"type": "status", "status": head.status}}) + "\n"
                audit(head.answer, head.status)

            return StreamingResponse(ndjson_items(), content_type="application/x-ndjson")

        @r.post("/api/v1/kb/{kbid}/ask")
        def ask(request: Request):
            kbid = self._kbid(request)
            req = _validate(AskRequest, _apply_search_config(kbid, request.json()))
            self._sync()
            return _run_ask(request, kbid, req)

        # ---- vocabulary services (writer/api/v1/services.py parity) -----

        @r.post("/api/v1/kb/{kbid}/labelset/{labelset}")
        def set_labelset(request: Request):
            kbid = self._kbid(request)
            self.labels.set_labelset(kbid, request.params["labelset"], request.json())
            return 201, {"ok": True}

        @r.get("/api/v1/kb/{kbid}/labelsets")
        def list_labelsets(request: Request):
            kbid = self._kbid(request)
            return {"labelsets": self.labels.list_labelsets(kbid)}

        @r.get("/api/v1/kb/{kbid}/labelset/{labelset}")
        def get_labelset(request: Request):
            kbid = self._kbid(request)
            out = self.labels.get_labelset(kbid, request.params["labelset"])
            if out is None:
                raise HTTPError(404, "unknown labelset")
            return out

        @r.delete("/api/v1/kb/{kbid}/labelset/{labelset}")
        def delete_labelset(request: Request):
            kbid = self._kbid(request)
            self.labels.delete_labelset(kbid, request.params["labelset"])
            return 204, None

        @r.post("/api/v1/kb/{kbid}/entitiesgroup/{group}")
        def set_entities(request: Request):
            kbid = self._kbid(request)
            self.entities.set_group(kbid, request.params["group"], request.json())
            return 201, {"ok": True}

        @r.get("/api/v1/kb/{kbid}/entitiesgroups")
        def list_entities(request: Request):
            kbid = self._kbid(request)
            return {"groups": self.entities.list_groups(kbid)}

        @r.get("/api/v1/kb/{kbid}/entitiesgroup/{group}")
        def get_entities(request: Request):
            kbid = self._kbid(request)
            out = self.entities.get_group(kbid, request.params["group"])
            if out is None:
                raise HTTPError(404, "unknown entities group")
            return out

        @r.delete("/api/v1/kb/{kbid}/entitiesgroup/{group}")
        def delete_entities(request: Request):
            kbid = self._kbid(request)
            self.entities.delete_group(kbid, request.params["group"])
            return 204, None

        @r.post("/api/v1/kb/{kbid}/custom-synonyms")
        def set_synonyms(request: Request):
            kbid = self._kbid(request)
            self.synonyms.set_synonyms(kbid, request.json())
            return 201, {"ok": True}

        @r.get("/api/v1/kb/{kbid}/custom-synonyms")
        def get_synonyms(request: Request):
            kbid = self._kbid(request)
            return {"synonyms": self.synonyms.get_synonyms(kbid)}

        @r.delete("/api/v1/kb/{kbid}/custom-synonyms")
        def delete_synonyms(request: Request):
            kbid = self._kbid(request)
            self.synonyms.delete_synonyms(kbid)
            return 204, None

        # ---- augment + learning config -----------------------------------

        @r.post("/api/v1/kb/{kbid}/augment")
        def augment(request: Request):
            kbid = self._kbid(request)
            req = _validate(AugmentRequest, request.json())
            return self.augmentor.augment(kbid, req)

        @r.get("/api/v1/kb/{kbid}/configuration")
        def get_learning(request: Request):
            kbid = self._kbid(request)
            return self.learning.get_configuration(kbid)

        @r.patch("/api/v1/kb/{kbid}/configuration")
        def set_learning(request: Request):
            kbid = self._kbid(request)
            return self.learning.set_configuration(kbid, request.json())

        @r.post("/api/v1/kb/{kbid}/configuration")
        def post_learning(request: Request):
            """Strict create/replace: unknown fields 422 (parity: the
            reference's POST /configuration schema validation)."""
            kbid = self._kbid(request)
            body = request.json() or {}
            try:
                self.learning.validate_fields(body)
            except ValueError as e:
                raise HTTPError(422, str(e))
            return self.learning.set_configuration(kbid, body)

        @r.get("/api/v1/kb/{kbid}/schema")
        def learning_schema(request: Request):
            """Configuration JSON schema (parity: GET /schema)."""
            kbid = self._kbid(request)
            return self.learning.get_schema(kbid)

        @r.get("/api/v1/kb/{kbid}/generative_providers")
        def generative_providers(request: Request):
            """Provider -> generative models (parity: /generative_providers)."""
            kbid = self._kbid(request)
            return self.learning.generative_providers(kbid)

        @r.get("/api/v1/nua/schema")
        def nua_schema(request: Request):
            """Global learning configuration schema (parity: GET
            /nua/schema — the per-KB schema without a KB)."""
            return self.learning.get_schema("")

        def _strategy_routes(kind: str):
            """extract_strategies / split_strategies CRUD (parity:
            writer/api/v1/learning_config.py:66-140 + the reader GETs)."""

            def add(request: Request, kind=kind):
                kbid = self._kbid(request)
                body = request.json() or {}
                if not isinstance(body, dict):
                    raise HTTPError(422, "strategy config must be an object")
                return self.learning.add_strategy(kbid, kind, body)

            def list_(request: Request, kind=kind):
                kbid = self._kbid(request)
                return self.learning.list_strategies(kbid, kind)

            def get_one(request: Request, kind=kind):
                kbid = self._kbid(request)
                out = self.learning.get_strategy(
                    kbid, kind, request.params["strategy_id"]
                )
                if out is None:
                    raise HTTPError(404, "unknown strategy")
                return out

            def delete(request: Request, kind=kind):
                kbid = self._kbid(request)
                if not self.learning.delete_strategy(
                    kbid, kind, request.params["strategy_id"]
                ):
                    raise HTTPError(404, "unknown strategy")
                return Response(status=204)

            base = f"/api/v1/kb/{{kbid}}/{kind}_strategies"
            r.add("POST", base, add)
            r.add("GET", base, list_)
            r.add("GET", base + "/strategy/{strategy_id}", get_one)
            r.add("DELETE", base + "/strategy/{strategy_id}", delete)

        _strategy_routes("extract")
        _strategy_routes("split")

        @r.get("/api/v1/kb/{kbid}/model/{model_id}")
        def get_model(request: Request):
            """Single-model metadata (parity: reader /model/{model_id} —
            proxied to learning; embedded reports the configured models)."""
            kbid = self._kbid(request)
            model_id = request.params["model_id"]
            config = self.learning.get_configuration(kbid)
            known = {config.get("generative_model"), config.get("semantic_model")}
            known |= set(config.get("semantic_models") or [])
            known |= set(self.kbs.get_config(kbid).vectorsets or {})
            if model_id not in known:
                raise HTTPError(404, f"unknown model {model_id}")
            return {"model_id": model_id, "location": "local"}

        @r.get("/api/v1/kb/{kbid}/models/{model_id}/{filename}")
        def download_model_file(request: Request):
            """Model file download (parity: reader /models/{id}/{filename} —
            a learning-backend proxy; embedded deployments hold no model
            artifacts, so this 404s unless a proxy base_url is set)."""
            self._kbid(request)
            raise HTTPError(
                404,
                "model files are served by the learning backend; none is"
                " configured in this embedded deployment",
            )

        # ---- export / import / backups -------------------------------------

        @r.get("/api/v1/kb/{kbid}/export")
        def export(request: Request):
            from ..common.export_import import export_kb

            kbid = self._kbid(request)
            return 200, export_kb(
                self.kbs, self.processor, kbid, self.node.storage
            )

        @r.post("/api/v1/kbs/import")
        def import_(request: Request):
            from ..common.export_import import import_kb

            kbid = import_kb(
                self.kbs, self.processor, request.body,
                slug=request.query.get("slug"), storage=self.node.storage,
            )
            return 201, {"uuid": kbid}

        @r.post("/api/v1/kb/{kbid}/export")
        def start_export(request: Request):
            """Async-API parity: the reference creates an export job and
            polls its status (export/{id}/status); embedded exports complete
            synchronously, so the job is born finished and the payload is
            stored for a later GET export/{id}."""
            from ..common.export_import import export_kb

            kbid = self._kbid(request)
            export_id = uuid.uuid4().hex
            self.node.storage.put(
                f"exports/{kbid}/{export_id}",
                export_kb(self.kbs, self.processor, kbid, self.node.storage),
            )
            return 201, {"export_id": export_id}

        @r.get("/api/v1/kb/{kbid}/export/{export_id}")
        def get_export(request: Request):
            kbid = self._kbid(request)
            key = f"exports/{kbid}/{request.params['export_id']}"
            if not self.node.storage.exists(key):
                raise HTTPError(404, "unknown export")
            return 200, self.node.storage.get(key)

        @r.get("/api/v1/kb/{kbid}/export/{export_id}/status")
        def export_status(request: Request):
            kbid = self._kbid(request)
            key = f"exports/{kbid}/{request.params['export_id']}"
            if not self.node.storage.exists(key):
                raise HTTPError(404, "unknown export")
            return {"status": "finished", "total": 100, "processed": 100}

        @r.post("/api/v1/kb/{kbid}/import")
        def import_into(request: Request):
            from ..common.export_import import import_kb

            kbid = self._kbid(request)
            import_kb(
                self.kbs, self.processor, request.body, kbid=kbid,
                storage=self.node.storage,
            )
            import_id = uuid.uuid4().hex
            self._imports_done.add(import_id)
            return 200, {"import_id": import_id}

        @r.get("/api/v1/kb/{kbid}/import/{import_id}/status")
        def import_status(request: Request):
            self._kbid(request)
            if request.params["import_id"] not in self._imports_done:
                raise HTTPError(404, "unknown import")
            return {"status": "finished", "total": 100, "processed": 100}

        @r.post("/api/v1/kb/{kbid}/backup")
        def backup(request: Request):
            from ..common.export_import import create_backup

            kbid = self._kbid(request)
            backup_id = create_backup(self.kbs, self.processor, self.node.storage, kbid)
            return 201, {"backup_id": backup_id}

        @r.post("/api/v1/backups/{backup_id}/restore")
        def restore(request: Request):
            from ..common.export_import import restore_backup

            kbid = restore_backup(
                self.kbs, self.processor, self.node.storage,
                request.params["backup_id"], slug=request.query.get("slug"),
            )
            return 201, {"uuid": kbid}

        @r.get("/api/v1/backups")
        def backups(request: Request):
            from ..common.export_import import list_backups

            return {"backups": list_backups(self.node.storage)}

        @r.delete("/api/v1/backups/{backup_id}")
        def delete_backup_route(request: Request):
            from ..common.export_import import delete_backup, list_backups

            backup_id = request.params["backup_id"]
            if backup_id not in list_backups(self.node.storage):
                raise HTTPError(404, "unknown backup")
            delete_backup(self.node.storage, backup_id)
            return 204, None

        # ---- train ----------------------------------------------------------

        @r.get("/api/v1/kb/{kbid}/trainset")
        def trainset_partitions(request: Request):
            """Trainset partitions = the KB's shard ids (parity:
            train/api/v1/trainset.py get_partitions_all — partitions are
            shard replica ids the client then streams one by one)."""
            kbid = self._kbid(request)
            shards = self.kbs.get_shards(kbid)
            if shards is None:
                raise HTTPError(404, "no shards found for kb")
            return {"partitions": list(shards.shards)}

        @r.get("/api/v1/kb/{kbid}/trainset/{prefix}")
        def trainset_partitions_prefix(request: Request):
            kbid = self._kbid(request)
            shards = self.kbs.get_shards(kbid)
            if shards is None:
                raise HTTPError(404, "no shards found for kb")
            prefix = request.params["prefix"]
            return {"partitions": [s for s in shards.shards if s.startswith(prefix)]}

        @r.post("/api/v1/kb/{kbid}/trainset/{task}")
        def trainset(request: Request):
            from ..train import TrainSet, export_trainset
            from ..train.dataset import stream_trainset

            kbid = self._kbid(request)
            body = request.json()
            # reference-style streaming body: {"type": ..., "batch_size": ...}
            # streams the Arrow IPC bytes instead of writing partition files
            # (parity: train/api/v1/shards.py object_get_response)
            task = str(body.get("type") or request.params["task"]).lower()
            ts = TrainSet(kbid=kbid, batch_size=int(body.get("batch_size", 32)))
            if body.get("stream") or body.get("type"):
                from ..train.dataset import GENERATORS

                if task not in GENERATORS:
                    raise HTTPError(
                        422, f"unknown train task {task!r}; options: {sorted(GENERATORS)}"
                    )
                return StreamingResponse(
                    stream_trainset(self.processor, ts, task),
                    content_type="application/octet-stream",
                )
            try:
                manifest = export_trainset(
                    self.processor,
                    ts,
                    task,
                    body.get("output_dir") or os.path.join(
                        self.node.data_dir, "trainsets", kbid, task
                    ),
                    format=body.get("format", "arrow"),
                )
            except ValueError as e:
                raise HTTPError(422, str(e))
            return 201, manifest

        # ---- admin ------------------------------------------------------------

        @r.post("/api/v1/admin/rollover/{kbid}")
        def rollover(request: Request):
            from ..common.rollover import rollover_kb

            kbid = self._kbid(request)
            shards = rollover_kb(self.kbs, self.processor, self.node, kbid)
            self._sync(force=True)
            return {"shards": shards}

        @r.post("/api/v1/admin/rebalance/{kbid}")
        def rebalance(request: Request):
            from ..common.rollover import rebalance_kb

            kbid = self._kbid(request)
            counts = rebalance_kb(self.kbs, self.processor, self.node, kbid)
            self._sync(force=True)
            return {"counts": counts}

        @r.post("/api/v1/admin/tick")
        def tick(request: Request):
            stats = self.node.tick_background()
            self._sync(force=True)
            return stats

        @r.post("/api/v1/admin/loglevel")
        def set_log_level(request: Request):
            """Dynamic log level (parity: nidx telemetry.rs:57-60 runtime
            log-level switch; Python logs.py dynamic levels)."""
            import logging as _logging

            body = request.json() or {}
            level = str(body.get("level", "")).upper()
            if level not in ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"):
                raise HTTPError(422, f"unknown level {level!r}")
            name = body.get("logger", "nucliadb_tpu")
            _logging.getLogger(name).setLevel(level)
            return {"logger": name, "level": level}

        @r.get("/api/v1/admin/shards/{kbid}")
        def kb_shards(request: Request):
            kbid = self._kbid(request)
            shards = self.kbs.get_shards(kbid)
            return {
                "shards": shards.shards if shards else [],
                "writable": shards.writable if shards else 0,
                "counts": shards.counts if shards else {},
            }

        # ---- raw retrieval + resource-scoped search/ask -------------------
        # (parity: search/api/v1/retrieve.py and search/api/v1/resource/)

        @r.post("/api/v1/kb/{kbid}/retrieve")
        def retrieve(request: Request):
            from ..models.api import RetrievalRequest

            kbid = self._kbid(request)
            req = _validate(RetrievalRequest, request.json())
            self._sync()
            t0 = time.monotonic()
            out = self.search.retrieve(kbid, req)
            user, client = _audit_ctx(request)
            self.audit.search(
                kbid, "", len(out.matches), user=user, client_type=client,
                duration_ms=(time.monotonic() - t0) * 1e3,
            )
            return out

        def _resource_search(request: Request, body: dict):
            kbid = self._kbid(request)
            rid = request.params["rid"]
            if self.processor.get_meta(kbid, rid) is None:
                raise HTTPError(404, "unknown resource")
            req = FindRequest(
                query=body.get("query", ""),
                top_k=int(body.get("top_k", 20)),
                features=[SearchFeature.KEYWORD],
                fields=[rid],  # key-prefix scope: every paragraph key leads with rid
                # GET passes the raw query string ('false' must not enable)
                highlight=(
                    h.lower() in ("1", "true", "yes")
                    if isinstance(h := body.get("highlight", False), str)
                    else bool(h)
                ),
            )
            self._sync()
            results = self.search.find(kbid, req)
            paragraphs = []
            for resource in results.resources.values():
                for fid, field in resource.fields.items():
                    for pid, para in field.paragraphs.items():
                        paragraphs.append(
                            {
                                "rid": rid,
                                "field": fid,
                                "score": para.score,
                                "order": para.order,
                                "text": para.text,
                                "id": pid,
                                "labels": para.labels,
                                "position": para.position,
                            }
                        )
            paragraphs.sort(key=lambda p: p["order"])
            return {
                "paragraphs": {"results": paragraphs, "total": results.total},
            }

        @r.get("/api/v1/kb/{kbid}/resource/{rid}/search")
        def resource_search_get(request: Request):
            return _resource_search(request, dict(request.query))

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/search")
        def resource_search_post(request: Request):
            return _resource_search(request, request.json() or {})

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/ask")
        def resource_ask(request: Request):
            # retrieval scoped to one resource (parity:
            # search/api/v1/resource/ask.py)
            kbid = self._kbid(request)
            rid = request.params["rid"]
            if self.processor.get_meta(kbid, rid) is None:
                raise HTTPError(404, "unknown resource")
            req = _validate(AskRequest, _apply_search_config(kbid, request.json()))
            req.fields = [rid]
            self._sync()
            return _run_ask(request, kbid, req)

        @r.post("/api/v1/kb/{kbid}/resource/{rid}/run-agents")
        def run_agents(request: Request):
            """Ingestion agents over one resource (parity:
            search/api/v1/resource/ingestion_agents.py run_agents). Agents
            are a Predict-side capability: with a predict engine exposing
            run_agents the augmented fields come back from it; the embedded
            fallback reports every field unchanged."""
            kbid = self._kbid(request)
            rid = request.params["rid"]
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                raise HTTPError(404, "unknown resource")
            body = request.json() or {}
            wanted = set(body.get("filters", []) or [])
            results = {}
            for fid, text_field in payload.texts.items():
                if wanted and fid not in wanted:
                    continue
                if self.search.predict is not None and hasattr(
                    self.search.predict, "run_agents"
                ):
                    aug = self.search.predict.run_agents(
                        kbid, rid, fid, text_field.body
                    )
                    results[f"/t/{fid}"] = {
                        "applied_data_augmentation": aug,
                        "changed": bool(aug),
                    }
                else:
                    results[f"/t/{fid}"] = {
                        "applied_data_augmentation": {},
                        "changed": False,
                    }
            return {"resource": rid, "results": results}

        @r.get("/api/v1/kb/{kbid}/resource/{rid}/{field_type}/{field_id}/download/extracted/{download_field}")
        def download_extracted(request: Request):
            """Serve extracted content of a field (parity: reader
            download.py download_extract_file_*). In the embedded build the
            extraction artifact is the text landed by local extraction (an
            EXTRACTED-format text field), served as text/plain; binary
            artifacts (thumbnails…) come from the processing service, which
            is an external seam here."""
            kbid = self._kbid(request)
            rid = request.params["rid"]
            payload = self.processor.get_payload(kbid, rid)
            if payload is None:
                raise HTTPError(404, "unknown resource")
            field_id = request.params["field_id"]
            text_field = payload.texts.get(field_id)
            if text_field is None:
                raise HTTPError(404, "no extracted content for field")
            return _serve_blob(
                request, text_field.body.encode(), "text/plain; charset=utf-8"
            )

        # ---- slug-addressed twins ----------------------------------------
        # every /resource/{rid}/... route also answers under
        # /slug/{rslug}/... (parity: the reference registers an RSLUG_PREFIX
        # variant of each writer/reader resource route)

        def _slug_adapter(handler):
            def by_slug(request: Request):
                kbid = self._kbid(request)
                rid = self.processor.resolve_slug(kbid, request.params.pop("rslug"))
                if rid is None:
                    raise HTTPError(404, "unknown resource slug")
                request.params["rid"] = rid
                return handler(request)

            by_slug.__name__ = handler.__name__ + "_by_slug"
            by_slug.__doc__ = handler.__doc__
            return by_slug

        existing = {(m, t) for (m, _, _), t in zip(r.routes, r.templates)}
        for (method, _, handler), template in list(zip(r.routes, r.templates)):
            if "/resource/{rid}" not in template:
                continue
            twin = template.replace("/resource/{rid}", "/slug/{rslug}")
            if (method, twin) in existing:
                continue
            r.add(method, twin, _slug_adapter(handler))

"""Typed HTTP client for the nucliadb_tpu API.

The port's copy of ``nucliadb_tpu/sdk/client.py``,
kept verbatim: the port imports nothing of the JAX package. Every model it
builds or parses is the port's own (``..models.api``); a model of the JAX
package is a different class, so a caller converts it first.
"""

from __future__ import annotations

from typing import Optional

import httpx

from ..models.api import (
    AskRequest,
    AskResponse,
    CatalogRequest,
    CatalogResponse,
    CreateResourcePayload,
    FindRequest,
    GraphSearchPayload,
    GraphSearchResponse,
    KnowledgeBoxConfig,
    KnowledgeBoxObj,
    KnowledgeboxFindResults,
    ResourceCreated,
    SuggestRequest,
    SuggestResponse,
    UpdateResourcePayload,
    VectorSetSpec,
)


class NucliaDBClient:
    """HTTP client covering the full API surface (parity: nucliadb_sdk's
    NucliaDB client, generated around the REST API; here hand-rolled and
    typed against models.api)."""

    def __init__(
        self,
        base_url: str = "http://127.0.0.1:8080",
        timeout: float = 60.0,
        *,
        api_key: str = "",
        user: str = "",
        client_type: str = "",
    ):
        headers = {}
        if api_key:
            headers["authorization"] = f"Bearer {api_key}"
        if user:
            headers["x-nucliadb-user"] = user
        if client_type:
            headers["x-ndb-client"] = client_type
        self._client = httpx.Client(base_url=base_url, timeout=timeout, headers=headers)

    def close(self) -> None:
        self._client.close()

    def _raise(self, resp: httpx.Response) -> None:
        if resp.status_code >= 400:
            raise httpx.HTTPStatusError(
                f"{resp.status_code}: {resp.text}", request=resp.request, response=resp
            )

    # ---- knowledge boxes -------------------------------------------------

    def create_kb(self, config: KnowledgeBoxConfig) -> KnowledgeBoxObj:
        resp = self._client.post("/api/v1/kbs", json=config.model_dump())
        self._raise(resp)
        return KnowledgeBoxObj.model_validate(resp.json())

    def list_kbs(self) -> list[dict]:
        """KB summaries [{uuid, slug}] (parity: KnowledgeBoxList)."""
        resp = self._client.get("/api/v1/kbs")
        self._raise(resp)
        return resp.json()["kbs"]

    def get_kb(self, kbid: str) -> KnowledgeBoxObj:
        resp = self._client.get(f"/api/v1/kb/{kbid}")
        self._raise(resp)
        return KnowledgeBoxObj.model_validate(resp.json())

    def get_kb_by_slug(self, slug: str) -> KnowledgeBoxObj:
        resp = self._client.get(f"/api/v1/kb/s/{slug}")
        self._raise(resp)
        return KnowledgeBoxObj.model_validate(resp.json())

    def delete_kb(self, kbid: str) -> None:
        self._raise(self._client.delete(f"/api/v1/kb/{kbid}"))

    def add_vectorset(self, kbid: str, name: str, spec: VectorSetSpec) -> None:
        self._raise(
            self._client.post(
                f"/api/v1/kb/{kbid}/vectorsets/{name}", json=spec.model_dump()
            )
        )

    # ---- resources ---------------------------------------------------------

    def create_resource(self, kbid: str, payload: CreateResourcePayload) -> ResourceCreated:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/resources", json=payload.model_dump()
        )
        self._raise(resp)
        return ResourceCreated.model_validate(resp.json())

    def get_resource(self, kbid: str, rid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/resource/{rid}")
        self._raise(resp)
        return resp.json()

    def update_resource(self, kbid: str, rid: str, payload: UpdateResourcePayload) -> None:
        self._raise(
            self._client.patch(
                f"/api/v1/kb/{kbid}/resource/{rid}",
                json=payload.model_dump(exclude_unset=True),
            )
        )

    def delete_resource(self, kbid: str, rid: str) -> None:
        self._raise(self._client.delete(f"/api/v1/kb/{kbid}/resource/{rid}"))

    # ---- search ---------------------------------------------------------------

    def find(self, kbid: str, request: FindRequest) -> KnowledgeboxFindResults:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/find", json=request.model_dump(exclude_none=True)
        )
        self._raise(resp)
        return KnowledgeboxFindResults.model_validate(resp.json())

    def suggest(self, kbid: str, request: SuggestRequest) -> SuggestResponse:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/suggest", json=request.model_dump()
        )
        self._raise(resp)
        return SuggestResponse.model_validate(resp.json())

    def catalog(self, kbid: str, request: CatalogRequest) -> CatalogResponse:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/catalog", json=request.model_dump(exclude_none=True)
        )
        self._raise(resp)
        return CatalogResponse.model_validate(resp.json())

    def graph(self, kbid: str, request: GraphSearchPayload) -> GraphSearchResponse:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/graph", json=request.model_dump(exclude_none=True)
        )
        self._raise(resp)
        return GraphSearchResponse.model_validate(resp.json())

    def graph_query(self, kbid: str, query: dict, *, top_k: int = 50,
                    **extra) -> GraphSearchResponse:
        """Boolean path-query expression mode (and/or/not over
        path/node/relation leaves); extra kwargs pass through (security,
        show_hidden, filter_expression)."""
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/graph",
            json={"query": query, "top_k": top_k, **extra},
        )
        self._raise(resp)
        return GraphSearchResponse.model_validate(resp.json())

    def ask(self, kbid: str, request: AskRequest) -> AskResponse:
        # server default is the ndjson stream (reference parity); the SDK's
        # object API opts into the synchronous JSON body
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/ask", json=request.model_dump(exclude_none=True),
            headers={"x-synchronous": "true"},
        )
        self._raise(resp)
        return AskResponse.model_validate(resp.json())

    def retrieve(self, kbid: str, request) -> "RetrievalResponse":
        """Raw text-block retrieval with score history (POST /retrieve)."""
        from ..models.api import RetrievalRequest, RetrievalResponse

        if isinstance(request, dict):
            request = RetrievalRequest.model_validate(request)
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/retrieve", json=request.model_dump(exclude_none=True)
        )
        self._raise(resp)
        return RetrievalResponse.model_validate(resp.json())

    def resource_search(self, kbid: str, rid: str, query: str, *, top_k: int = 20) -> dict:
        resp = self._client.get(
            f"/api/v1/kb/{kbid}/resource/{rid}/search",
            params={"query": query, "top_k": top_k},
        )
        self._raise(resp)
        return resp.json()

    def resource_ask(self, kbid: str, rid: str, request: AskRequest) -> AskResponse:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/resource/{rid}/ask",
            json=request.model_dump(exclude_none=True),
            headers={"x-synchronous": "true"},
        )
        self._raise(resp)
        return AskResponse.model_validate(resp.json())

    def run_agents(self, kbid: str, rid: str, *, filters: Optional[list[str]] = None) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/resource/{rid}/run-agents",
            json={"filters": filters or []},
        )
        self._raise(resp)
        return resp.json()

    def versions(self) -> dict:
        resp = self._client.get("/api/v1/versions")
        self._raise(resp)
        return resp.json()

    def config_check(self) -> dict:
        resp = self._client.get("/api/v1/config-check")
        self._raise(resp)
        return resp.json()

    def temp_access_token(self) -> str:
        resp = self._client.get("/api/v1/temp-access-token")
        self._raise(resp)
        return resp.json()["token"]

    def trainset_partitions(self, kbid: str, prefix: str = "") -> list[str]:
        path = f"/api/v1/kb/{kbid}/trainset" + (f"/{prefix}" if prefix else "")
        resp = self._client.get(path)
        self._raise(resp)
        return resp.json()["partitions"]

    def trainset_stream(self, kbid: str, partition: str, task_type: str,
                        *, batch_size: int = 32) -> bytes:
        """Stream one partition's train data as Arrow IPC bytes. An empty
        body means the task produced no batches (e.g. no labelled fields
        for a classification task)."""
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/trainset/{partition}",
            json={"type": task_type, "batch_size": batch_size},
        )
        self._raise(resp)
        return resp.content

    # ---- resources by slug ------------------------------------------------

    def get_resource_by_slug(self, kbid: str, slug: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/slug/{slug}")
        self._raise(resp)
        return resp.json()

    # ---- files (parity: nucliadb_sdk upload helpers) -----------------------

    def upload_file(
        self, kbid: str, rid: str, field: str, data: bytes,
        *, filename: str = "", content_type: str = "application/octet-stream",
    ) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/resource/{rid}/file/{field}/upload",
            params={"filename": filename or field},
            content=data,
            headers={"content-type": content_type},
        )
        self._raise(resp)
        return resp.json()

    def tus_upload(
        self, kbid: str, rid: str, field: str, data: bytes,
        *, filename: str = "", content_type: str = "application/octet-stream",
        chunk_size: int = 4 * 1024 * 1024,
    ) -> None:
        """Resumable upload: TUS creation + offset-checked PATCH loop. On a
        connection error, re-HEADs the committed offset and resumes."""
        import base64

        meta = []
        if filename:
            meta.append("filename " + base64.b64encode(filename.encode()).decode())
        if content_type:
            meta.append(
                "content_type " + base64.b64encode(content_type.encode()).decode()
            )
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/resource/{rid}/file/{field}/tusupload",
            headers={
                "tus-resumable": "1.0.0",
                "upload-length": str(len(data)),
                "upload-metadata": ",".join(meta),
            },
        )
        self._raise(resp)
        location = resp.headers["location"]
        offset = 0
        stalled = 0  # consecutive attempts without progress
        # at least one PATCH always goes out: the server only finalizes the
        # upload (blob + file-field record) inside PATCH, including size 0
        while True:
            chunk = data[offset : offset + chunk_size]
            try:
                resp = self._client.patch(
                    location,
                    content=chunk,
                    headers={
                        "tus-resumable": "1.0.0",
                        "upload-offset": str(offset),
                        "content-type": "application/offset+octet-stream",
                    },
                )
                self._raise(resp)
                new_offset = int(resp.headers["upload-offset"])
            except (httpx.TransportError,):
                head = self._client.request("HEAD", location)
                self._raise(head)
                new_offset = int(head.headers["upload-offset"])
            stalled = 0 if new_offset > offset else stalled + 1
            if stalled >= 5:
                raise RuntimeError(
                    f"tus upload stalled at offset {new_offset}/{len(data)} "
                    "after 5 attempts without progress"
                )
            offset = new_offset
            if offset >= len(data):
                break

    def download_file(self, kbid: str, rid: str, field: str) -> bytes:
        resp = self._client.get(
            f"/api/v1/kb/{kbid}/resource/{rid}/file/{field}/download"
        )
        self._raise(resp)
        return resp.content

    # ---- notifications ------------------------------------------------------

    def notifications(self, kbid: str, since: int = 0, limit: int = 100) -> list[dict]:
        resp = self._client.get(
            f"/api/v1/kb/{kbid}/notifications",
            params={"since": since, "limit": limit},
        )
        self._raise(resp)
        return resp.json()["notifications"]

    def notifications_stream(self, kbid: str, timeout: float = 30.0):
        """Yields live notification events from the SSE endpoint."""
        import json as _json

        with self._client.stream(
            "GET",
            f"/api/v1/kb/{kbid}/notifications",
            params={"timeout": timeout},
            headers={"accept": "text/event-stream"},
        ) as resp:
            if resp.status_code >= 400:
                resp.read()
                self._raise(resp)
            for line in resp.iter_lines():
                if line.startswith("data: "):
                    yield _json.loads(line[len("data: "):])

    # ---- vocabulary services -----------------------------------------------

    def set_labelset(self, kbid: str, labelset: str, payload: dict) -> None:
        self._raise(
            self._client.post(f"/api/v1/kb/{kbid}/labelset/{labelset}", json=payload)
        )

    def get_labelsets(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/labelsets")
        self._raise(resp)
        return resp.json()["labelsets"]

    def set_entities_group(self, kbid: str, group: str, payload: dict) -> None:
        self._raise(
            self._client.post(f"/api/v1/kb/{kbid}/entitiesgroup/{group}", json=payload)
        )

    def set_synonyms(self, kbid: str, synonyms: dict) -> None:
        self._raise(
            self._client.post(f"/api/v1/kb/{kbid}/custom-synonyms", json=synonyms)
        )

    # ---- export / import / backups ------------------------------------------

    def export_kb(self, kbid: str) -> bytes:
        resp = self._client.get(f"/api/v1/kb/{kbid}/export")
        self._raise(resp)
        return resp.content

    def import_kb(self, blob: bytes, slug: str = "") -> str:
        resp = self._client.post(
            "/api/v1/kbs/import", params={"slug": slug} if slug else {}, content=blob
        )
        self._raise(resp)
        return resp.json()["uuid"]

    def backup_kb(self, kbid: str) -> str:
        resp = self._client.post(f"/api/v1/kb/{kbid}/backup")
        self._raise(resp)
        return resp.json()["backup_id"]

    def delete_labelset(self, kbid: str, labelset: str) -> None:
        self._raise(self._client.delete(f"/api/v1/kb/{kbid}/labelset/{labelset}"))

    def get_labelset(self, kbid: str, labelset: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/labelset/{labelset}")
        self._raise(resp)
        return resp.json()

    def get_entities_group(self, kbid: str, group: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/entitiesgroup/{group}")
        self._raise(resp)
        return resp.json()

    def delete_entities_group(self, kbid: str, group: str) -> None:
        self._raise(self._client.delete(f"/api/v1/kb/{kbid}/entitiesgroup/{group}"))

    def get_synonyms(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/custom-synonyms")
        self._raise(resp)
        return resp.json()

    # ---- vectorsets ---------------------------------------------------------

    def list_vectorsets(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/vectorsets")
        self._raise(resp)
        return resp.json()

    def delete_vectorset(self, kbid: str, name: str) -> None:
        self._raise(self._client.delete(f"/api/v1/kb/{kbid}/vectorsets/{name}"))

    # ---- resource listing / counters / feedback -------------------------------

    def list_resources(self, kbid: str, page: int = 0, size: int = 20) -> dict:
        resp = self._client.get(
            f"/api/v1/kb/{kbid}/resources", params={"page": page, "size": size}
        )
        self._raise(resp)
        return resp.json()

    def counters(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/counters")
        self._raise(resp)
        return resp.json()

    def feedback(self, kbid: str, payload: dict) -> None:
        self._raise(self._client.post(f"/api/v1/kb/{kbid}/feedback", json=payload))

    def summarize(self, kbid: str, resources: list[str]) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/summarize", json={"resources": resources}
        )
        self._raise(resp)
        return resp.json()

    def reindex_resource(self, kbid: str, rid: str) -> None:
        self._raise(self._client.post(f"/api/v1/kb/{kbid}/resource/{rid}/reindex"))

    # ---- graph sub-queries -----------------------------------------------------

    def graph_nodes(self, kbid: str, payload: Optional[dict] = None) -> dict:
        resp = self._client.post(f"/api/v1/kb/{kbid}/graph/nodes", json=payload or {})
        self._raise(resp)
        return resp.json()

    def graph_relations(self, kbid: str, payload: Optional[dict] = None) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/graph/relations", json=payload or {}
        )
        self._raise(resp)
        return resp.json()

    # ---- predict proxy / hydrate / status ---------------------------------------

    def predict(self, kbid: str, endpoint: str, payload: dict) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/predict/{endpoint}", json=payload
        )
        self._raise(resp)
        return resp.json()

    def hydrate(self, kbid: str, paragraphs: Optional[list[str]] = None,
                fields: Optional[list[str]] = None) -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/hydrate",
            json={"paragraphs": paragraphs or [], "fields": fields or []},
        )
        self._raise(resp)
        return resp.json()

    def processing_status(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/processing-status")
        self._raise(resp)
        return resp.json()

    # ---- configuration / search configurations ---------------------------------

    def get_configuration(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/configuration")
        self._raise(resp)
        return resp.json()

    def patch_configuration(self, kbid: str, payload: dict) -> dict:
        resp = self._client.patch(f"/api/v1/kb/{kbid}/configuration", json=payload)
        self._raise(resp)
        return resp.json()

    def set_configuration(self, kbid: str, payload: dict) -> dict:
        """Strict create/replace (POST; unknown fields 422)."""
        resp = self._client.post(f"/api/v1/kb/{kbid}/configuration", json=payload)
        self._raise(resp)
        return resp.json()

    def configuration_schema(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/schema")
        self._raise(resp)
        return resp.json()

    def nua_schema(self) -> dict:
        resp = self._client.get("/api/v1/nua/schema")
        self._raise(resp)
        return resp.json()

    def generative_providers(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/generative_providers")
        self._raise(resp)
        return resp.json()

    def add_strategy(self, kbid: str, kind: str, config: dict) -> str:
        """kind: 'extract' | 'split' (parity: extract/split_strategies)."""
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/{kind}_strategies", json=config
        )
        self._raise(resp)
        return resp.json()

    def list_strategies(self, kbid: str, kind: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/{kind}_strategies")
        self._raise(resp)
        return resp.json()

    def delete_strategy(self, kbid: str, kind: str, strategy_id: str) -> None:
        self._raise(
            self._client.delete(
                f"/api/v1/kb/{kbid}/{kind}_strategies/strategy/{strategy_id}"
            )
        )

    def list_search_configurations(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/kb/{kbid}/search_configurations")
        self._raise(resp)
        return resp.json()

    # ---- backups / trainsets -----------------------------------------------------

    def restore_backup(self, backup_id: str, slug: str = "") -> str:
        resp = self._client.post(
            f"/api/v1/backups/{backup_id}/restore",
            params={"slug": slug} if slug else {},
        )
        self._raise(resp)
        return resp.json()["uuid"]

    def list_backups(self) -> list[str]:
        resp = self._client.get("/api/v1/backups")
        self._raise(resp)
        return resp.json()["backups"]

    def delete_backup(self, backup_id: str) -> None:
        self._raise(self._client.delete(f"/api/v1/backups/{backup_id}"))

    def export_trainset(self, kbid: str, task: str, *, batch_size: int = 32,
                        format: str = "arrow") -> dict:
        resp = self._client.post(
            f"/api/v1/kb/{kbid}/trainset/{task}",
            json={"batch_size": batch_size, "format": format},
        )
        self._raise(resp)
        return resp.json()

    # ---- admin -------------------------------------------------------------------

    def admin_rollover(self, kbid: str) -> dict:
        resp = self._client.post(f"/api/v1/admin/rollover/{kbid}")
        self._raise(resp)
        return resp.json()

    def admin_rebalance(self, kbid: str) -> dict:
        resp = self._client.post(f"/api/v1/admin/rebalance/{kbid}")
        self._raise(resp)
        return resp.json()

    def admin_tick(self) -> dict:
        resp = self._client.post("/api/v1/admin/tick")
        self._raise(resp)
        return resp.json()

    def admin_shards(self, kbid: str) -> dict:
        resp = self._client.get(f"/api/v1/admin/shards/{kbid}")
        self._raise(resp)
        return resp.json()

    def set_log_level(self, logger: str, level: str) -> dict:
        resp = self._client.post(
            "/api/v1/admin/loglevel", json={"logger": logger, "level": level}
        )
        self._raise(resp)
        return resp.json()

    # ---- misc -----------------------------------------------------------------

    def openapi(self) -> dict:
        resp = self._client.get("/api/v1/openapi.json")
        self._raise(resp)
        return resp.json()

    def ask_stream(self, kbid: str, request: AskRequest):
        """Yields AskResponseItem dicts from the ndjson stream."""
        import json as _json

        with self._client.stream(
            "POST",
            f"/api/v1/kb/{kbid}/ask",
            params={"stream": "ndjson"},
            json=request.model_dump(exclude_none=True),
        ) as resp:
            if resp.status_code >= 400:
                resp.read()
                self._raise(resp)
            for line in resp.iter_lines():
                if line.strip():
                    yield _json.loads(line)["item"]

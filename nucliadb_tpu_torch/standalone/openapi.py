"""OpenAPI 3.1 schema generation for the standalone REST API.

The port's copy of ``nucliadb_tpu/standalone/openapi.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: the reference serves generated OpenAPI docs per component
(nucliadb/src/nucliadb/openapi.py, FastAPI's /openapi.json). FastAPI is not
in this image, so the spec is built from the live Router: path templates
become parameterized operations, handler docstrings become descriptions, and
a (method, path) → pydantic model registry supplies request/response bodies
(schemas via `model_json_schema`, shared through #/components/schemas).
"""

from __future__ import annotations

import re
from typing import Any, Optional

from pydantic import BaseModel

from ..models import api as models
from ..http import Router
from ..version import __version__

_PARAM_RE = re.compile(r"\{(\w+)\}")

# (METHOD, path-template) -> (request model | None, response model | None).
# Routes not listed still appear in the spec with generic JSON bodies.
_BODIES: dict[tuple[str, str], tuple[Optional[type], Optional[type]]] = {
    ("POST", "/api/v1/kbs"): (models.KnowledgeBoxConfig, models.KnowledgeBoxObj),
    ("PATCH", "/api/v1/kb/{kbid}"): (models.KnowledgeBoxConfig, models.KnowledgeBoxObj),
    ("GET", "/api/v1/kb/{kbid}"): (None, models.KnowledgeBoxObj),
    ("POST", "/api/v1/kb/{kbid}/resources"): (
        models.CreateResourcePayload, models.ResourceCreated,
    ),
    ("PATCH", "/api/v1/kb/{kbid}/resource/{rid}"): (
        models.UpdateResourcePayload, models.ResourceCreated,
    ),
    ("POST", "/api/v1/kb/{kbid}/find"): (
        models.FindRequest, models.KnowledgeboxFindResults,
    ),
    ("POST", "/api/v1/kb/{kbid}/search"): (
        models.FindRequest, models.KnowledgeboxFindResults,
    ),
    ("POST", "/api/v1/kb/{kbid}/suggest"): (
        models.SuggestRequest, models.SuggestResponse,
    ),
    ("POST", "/api/v1/kb/{kbid}/catalog"): (
        models.CatalogRequest, models.CatalogResponse,
    ),
    ("POST", "/api/v1/kb/{kbid}/graph"): (
        models.GraphSearchPayload, models.GraphSearchResponse,
    ),
    ("POST", "/api/v1/kb/{kbid}/ask"): (models.AskRequest, models.AskResponse),
}

_TAG_RULES = [
    ("/find", "Search"), ("/search", "Search"), ("/suggest", "Search"),
    ("/catalog", "Search"), ("/graph", "Search"), ("/ask", "Search"),
    ("/augment", "Search"),
    ("tusupload", "Resource field TUS uploads"),
    ("/file/", "Resource fields"), ("/files", "Resource fields"),
    ("/resource", "Resources"), ("/slug/", "Resources"),
    ("/labelset", "Knowledge Box Services"),
    ("/entitiesgroup", "Knowledge Box Services"),
    ("/custom-synonyms", "Knowledge Box Services"),
    ("/configuration", "Knowledge Box Services"),
    ("/export", "Export/Import"), ("/import", "Export/Import"),
    ("/backup", "Export/Import"),
    ("/vectorset", "Vector Sets"),
    ("/notifications", "Notifications"),
    ("/train", "Train"), ("/admin", "Admin"),
    ("/kb", "Knowledge Boxes"),
    ("/health", "Health"), ("/metrics", "Observability"),
]


def _tag_for(path: str) -> str:
    for needle, tag in _TAG_RULES:
        if needle in path:
            return tag
    return "Misc"


def _ref_schema(model: type[BaseModel], components: dict[str, Any]) -> dict[str, Any]:
    schema = model.model_json_schema(
        ref_template="#/components/schemas/{model}"
    )
    for name, sub in schema.pop("$defs", {}).items():
        components.setdefault(name, sub)
    components.setdefault(model.__name__, schema)
    return {"$ref": f"#/components/schemas/{model.__name__}"}


def build_openapi(router: Router, title: str = "nucliadb_tpu") -> dict[str, Any]:
    components: dict[str, Any] = {}
    paths: dict[str, dict[str, Any]] = {}
    for (method, _regex, handler), template in zip(router.routes, router.templates):
        op: dict[str, Any] = {
            "operationId": f"{method.lower()}_{handler.__name__}",
            "tags": [_tag_for(template)],
            "responses": {"200": {"description": "OK"}},
        }
        doc = (handler.__doc__ or "").strip()
        if doc:
            op["summary"] = doc.splitlines()[0].strip()
            op["description"] = doc
        params = _PARAM_RE.findall(template)
        if params:
            op["parameters"] = [
                {
                    "name": p,
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for p in params
            ]
        body_model, resp_model = _BODIES.get((method, template), (None, None))
        if body_model is not None:
            op["requestBody"] = {
                "required": True,
                "content": {
                    "application/json": {
                        "schema": _ref_schema(body_model, components)
                    }
                },
            }
        elif method in ("POST", "PATCH", "PUT"):
            op["requestBody"] = {
                "required": False,
                "content": {"application/json": {"schema": {"type": "object"}}},
            }
        if resp_model is not None:
            op["responses"]["200"]["content"] = {
                "application/json": {"schema": _ref_schema(resp_model, components)}
            }
        paths.setdefault(template, {})[method.lower()] = op
    return {
        "openapi": "3.1.0",
        "info": {
            "title": title,
            "version": __version__,
            "description": "TPU-native NucliaDB-compatible search database "
            "(v1 REST surface parity).",
        },
        "paths": dict(sorted(paths.items())),
        "components": {"schemas": dict(sorted(components.items()))},
    }

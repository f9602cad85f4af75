"""The internal index message — the "brain" a resource is indexed from.

The port's copy of ``nucliadb_tpu/models/internal.py``, kept verbatim: the
port imports nothing of the JAX package.

Python-native equivalent of the reference's ``noderesources.Resource`` proto
(nidx/nidx_protos/noderesources.proto: Resource, IndexParagraph,
VectorSentence, TextInformation, IndexRelation) which the ingest pipeline
builds (nucliadb/src/nucliadb/ingest/orm/brain_v2.py) and every index
consumes. Dataclasses instead of protobuf for the in-process path; the gRPC
service layer serializes these when crossing processes.

Key conventions (parity with the reference):
- paragraph id:  ``{rid}/{field}/{start}-{end}``
- vector key:    ``{rid}/{field}/{index}/{start}-{end}`` (one per sentence)
- label hierarchy facets: ``/t`` (fieldtype), ``/l/{labelset}/{label}``,
  ``/n/s/{status}``, ``/e/{entity}``, ``/u``, ``/p`` … (docs/internal/SEARCH.md)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np


class ResourceStatus(str, Enum):
    PROCESSED = "PROCESSED"
    EMPTY = "EMPTY"
    ERROR = "ERROR"
    DELETE = "DELETE"
    PENDING = "PENDING"
    BLOCKED = "BLOCKED"
    EXPIRED = "EXPIRED"


@dataclass
class Position:
    start: int = 0
    end: int = 0
    index: int = 0
    page_number: int = 0
    in_page: bool = False
    start_seconds: list[int] = field(default_factory=list)
    end_seconds: list[int] = field(default_factory=list)


@dataclass
class VectorSentence:
    """One embedding for a sentence/chunk of a paragraph."""

    vector: np.ndarray
    position: Optional[Position] = None
    page_with_visual: bool = False
    is_a_table: bool = False
    representation_file: str = ""


@dataclass
class IndexParagraph:
    start: int = 0
    end: int = 0
    labels: list[str] = field(default_factory=list)
    # vector key -> sentence, per vectorset ("" = default vectorset)
    vectorsets_sentences: dict[str, dict[str, VectorSentence]] = field(default_factory=dict)
    fieldname: str = ""
    split: str = ""
    index: int = 0
    repeated_in_field: bool = False
    position: Optional[Position] = None


@dataclass
class TextInformation:
    text: str = ""
    labels: list[str] = field(default_factory=list)


@dataclass
class Security:
    access_groups: list[str] = field(default_factory=list)


@dataclass
class RelationNode:
    value: str = ""
    ntype: str = "ENTITY"  # ENTITY | RESOURCE | LABEL | USER | COLAB
    subtype: str = ""


@dataclass
class IndexRelation:
    source: RelationNode = field(default_factory=RelationNode)
    target: RelationNode = field(default_factory=RelationNode)
    relation: str = "ENTITY"  # CHILD | ABOUT | ENTITY | COLAB | SYNONYM | OTHER
    label: str = ""
    metadata: dict = field(default_factory=dict)
    facets: list[str] = field(default_factory=list)
    resource_field_id: Optional[str] = None


@dataclass
class ResourceDoc:
    """The full index message for one resource (the "brain")."""

    resource_id: str
    labels: list[str] = field(default_factory=list)
    status: ResourceStatus = ResourceStatus.PROCESSED
    created: float = 0.0  # unix ts
    modified: float = 0.0

    # field id ("{type}/{name}" e.g. "t/text1") -> full text + labels
    texts: dict[str, TextInformation] = field(default_factory=dict)
    # field id -> paragraph id -> paragraph
    paragraphs: dict[str, dict[str, IndexParagraph]] = field(default_factory=dict)
    # field id -> relations in that field
    relations: dict[str, list[IndexRelation]] = field(default_factory=dict)
    # graph semantic embeddings (noderesources.proto field_node_vectors=20 /
    # field_edge_vectors=21): field id -> vectorset -> node value (or
    # relation label) -> embedding. Feed the relation index's node/edge
    # vector tables, which serve GraphQuery VectorMatch at the node plane
    # (parity: nidx_vector/src/indexer.rs index_relation_nodes/edges)
    field_node_vectors: dict[str, dict[str, dict[str, np.ndarray]]] = field(
        default_factory=dict
    )
    field_edge_vectors: dict[str, dict[str, dict[str, np.ndarray]]] = field(
        default_factory=dict
    )
    # field id -> JSON-encoded value
    json_fields: dict[str, str] = field(default_factory=dict)

    security: Optional[Security] = None

    # deletion directives (applied as key-prefix deletions at the index layer)
    paragraphs_to_delete: list[str] = field(default_factory=list)
    vectors_to_delete_in_all_vectorsets: list[str] = field(default_factory=list)
    vector_prefixes_to_delete: dict[str, list[str]] = field(default_factory=dict)
    texts_to_delete: list[str] = field(default_factory=list)
    relation_fields_to_delete: list[str] = field(default_factory=list)
    json_fields_to_delete: list[str] = field(default_factory=list)

    skip_texts: bool = False
    skip_paragraphs: bool = False
    skip_json: bool = False

    def field_ids(self) -> list[str]:
        return sorted(set(self.texts) | set(self.paragraphs))


def paragraph_id(rid: str, field_id: str, start: int, end: int) -> str:
    return f"{rid}/{field_id}/{start}-{end}"


def vector_key(rid: str, field_id: str, index: int, start: int, end: int) -> str:
    return f"{rid}/{field_id}/{index}/{start}-{end}"

"""User-facing API models (pydantic).

The port's copy of ``nucliadb_tpu/models/api.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the essentials of the reference's ``nucliadb_models`` package:
knowledge box config, resource creation/update payloads, and the /find,
/search, /suggest, /catalog, /ask request-response surfaces. One deliberate
standalone extension: resources may carry inline ``embeddings`` per field
(the reference receives vectors from the external Nuclia Processing service
via BrokerMessages; an embedded deployment has no processing callback, so
the writer accepts them directly — same data, different transport).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Optional, Union

from pydantic import BaseModel, Field, model_validator


# ---- knowledge box --------------------------------------------------------


class VectorSetSpec(BaseModel):
    dimension: int
    similarity: str = "dot"  # dot | cosine
    quantization: str = "int8"  # none | int8 | binary
    multivector: bool = False


class KnowledgeBoxConfig(BaseModel):
    slug: str = ""
    title: str = ""
    description: str = ""
    vectorsets: dict[str, VectorSetSpec] = Field(default_factory=dict)
    shards: int = 1
    # route vector indexing/search to an external provider instead of the
    # node (parity: external_index_providers/base.py; e.g. {"type": "memory"})
    external_index_provider: Optional[dict] = None
    # hidden resources (parity: KB config hidden_resources_enabled /
    # hidden_resources_hide_on_creation; writer/api/v1/resource.py:102
    # rejects hiding when disabled)
    hidden_resources_enabled: bool = False
    hidden_resources_hide_on_creation: bool = False


class KnowledgeBoxObj(BaseModel):
    uuid: str
    slug: str = ""
    config: Optional[KnowledgeBoxConfig] = None


# ---- resources ------------------------------------------------------------


class SentenceEmbedding(BaseModel):
    start: int
    end: int
    vector: list[float]


class TextFieldPayload(BaseModel):
    body: str
    format: str = "PLAIN"
    # explicit field mimetype (indexed as the /mt facet); when empty, the
    # format maps to one. File extraction sets the source content type here.
    mimetype: str = ""


class ConversationAttachment(BaseModel):
    """A file carried by a conversation message. On write, ``payload`` is
    the base64 content (parity: push-payload b64 files in the reference's
    conversation fields); the server stores the blob and keeps only the
    storage ``key`` + ``size``, served back by the conversation
    download-field route (reader/api/v1/download.py
    download_field_conversation_attachment)."""

    filename: str = ""
    content_type: str = "application/octet-stream"
    payload: Optional[str] = None  # b64, write-only; stripped once stored
    key: str = ""  # blob-storage key, set server-side
    size: int = 0


class FilePayload(BaseModel):
    """Inline file content on a resource write (parity: the reference's
    FileField.file — models/file.py — with base64 ``payload``; the e2e
    flow creates resources as {"files": {"image": {"file": {...}}}})."""

    filename: str = ""
    content_type: str = "application/octet-stream"
    payload: Optional[str] = None  # b64, write-only; stripped once stored
    language: str = ""
    key: str = ""  # blob-storage key, set server-side
    size: int = 0


class FileFieldPayload(BaseModel):
    file: FilePayload = Field(default_factory=FilePayload)


class ConversationMessage(BaseModel):
    """One message of a conversation field (parity: reference conversation
    fields, writer/api/v1 conversation routes + models.ConversationField)."""

    text: str
    who: str = ""
    to: list[str] = Field(default_factory=list)
    ident: str = ""
    timestamp: float = 0.0
    files: list[ConversationAttachment] = Field(default_factory=list)


class ConversationFieldPayload(BaseModel):
    messages: list[ConversationMessage] = Field(default_factory=list)

    def transcript_lines(self) -> list[str]:
        """Canonical per-message lines. The brain builder computes
        paragraph offsets over '\n'.join(lines) and /find hydration slices
        the same join — ONE implementation keeps the offsets valid."""
        return [
            f"{m.who}: {m.text}" if m.who else m.text for m in self.messages
        ]

    def transcript(self) -> str:
        return "\n".join(self.transcript_lines())


class LinkFieldPayload(BaseModel):
    """Link field (parity: reference link fields; content extraction from
    the URI is the processing service's job — the stored title/description
    are what gets indexed here)."""

    uri: str
    title: str = ""
    description: str = ""
    language: str = ""


class Classification(BaseModel):
    labelset: str
    label: str


class RelationNodePayload(BaseModel):
    value: str
    type: str = "entity"
    group: str = ""


class RelationPayload(BaseModel):
    relation: str = "ENTITY"
    label: str = ""
    from_: Optional[RelationNodePayload] = Field(default=None, alias="from")
    to: Optional[RelationNodePayload] = None

    model_config = {"populate_by_name": True}


class UserMetadata(BaseModel):
    """Parity: nucliadb_models/metadata.py:135-137 — user relations live
    under usermetadata.relations on the wire; they are merged with the
    legacy top-level usergenerated_relations field by user_relations()."""

    classifications: list[Classification] = Field(default_factory=list)
    relations: list[RelationPayload] = Field(default_factory=list)


def user_relations(payload) -> list[RelationPayload]:
    """All user-authored relations on a resource payload, whichever of the
    two wire locations they arrived through (usermetadata.relations is the
    reference's shape; usergenerated_relations predates it here)."""
    rels = list(getattr(payload, "usergenerated_relations", []) or [])
    um = getattr(payload, "usermetadata", None)
    if um is not None:
        rels.extend(um.relations)
    return rels


class ComputedRelationPayload(RelationPayload):
    """A processor/data-augmentation-sourced relation (parity: processor
    broker messages' field_computed_metadata.relations, brain_v2.py:454-461
    — DA relations carry their task id and index the /g/da/<task> facet;
    plain processor relations index no /g facet)."""

    data_augmentation_task_id: Optional[str] = None


class ResourceSecurity(BaseModel):
    access_groups: list[str] = Field(default_factory=list)


class Origin(BaseModel):
    source_id: str = ""
    url: str = ""
    tags: list[str] = Field(default_factory=list)
    collaborators: list[str] = Field(default_factory=list)
    metadata: dict[str, str] = Field(default_factory=dict)
    # origin path, indexed as the /p facet hierarchy (origin_path filters)
    path: str = ""


class ResourceMetadataPayload(BaseModel):
    """User-settable resource metadata (parity: nucliadb_models metadata
    InputMetadata — primary language + other languages, indexed as the
    /s/p and /s/s facets the language filter matches)."""

    language: str = ""
    languages: list[str] = Field(default_factory=list)


class CreateResourcePayload(BaseModel):
    slug: str = ""
    title: str = ""
    summary: str = ""
    icon: str = ""
    texts: dict[str, TextFieldPayload] = Field(default_factory=dict)
    conversations: dict[str, ConversationFieldPayload] = Field(default_factory=dict)
    links: dict[str, LinkFieldPayload] = Field(default_factory=dict)
    # inline b64 file fields; blobs are stored (and extracted/indexed when
    # the format is supported) at create time
    files: dict[str, FileFieldPayload] = Field(default_factory=dict)
    # arbitrary JSON documents per field, indexed into the json filter index
    # (parity: reference key_value fields / kv-schemas)
    key_values: dict[str, dict] = Field(default_factory=dict)
    usermetadata: UserMetadata = Field(default_factory=UserMetadata)
    metadata: ResourceMetadataPayload = Field(default_factory=ResourceMetadataPayload)
    usergenerated_relations: list[RelationPayload] = Field(default_factory=list)
    # processor/DA-sourced relations (indexed with /g/da facets; the
    # reference receives these on processor broker messages)
    computed_relations: list[ComputedRelationPayload] = Field(default_factory=list)
    origin: Optional[Origin] = None
    # free-form user metadata blob, stored and served back verbatim
    # (parity: nucliadb_models/metadata.py Extra)
    extra: Optional[dict] = None
    security: Optional[ResourceSecurity] = None
    hidden: bool = False
    # standalone extension: vectorset -> field id -> sentence embeddings
    embeddings: dict[str, dict[str, list[SentenceEmbedding]]] = Field(
        default_factory=dict
    )


class UpdateResourcePayload(CreateResourcePayload):
    pass


class ResourceCreated(BaseModel):
    uuid: str
    seqid: Optional[int] = None


# ---- search ---------------------------------------------------------------


class SearchFeature(str, Enum):
    KEYWORD = "keyword"
    SEMANTIC = "semantic"
    RELATIONS = "relations"
    FULLTEXT = "fulltext"


# reference query-alias spellings for system label prefixes
# (nucliadb_models/labels.py LABEL_QUERY_ALIASES) — lets filter strings
# written against nucliadb ("/classification.labels/topic/sports") hit the
# same facets as the system form ("/l/topic/sports")
LABEL_QUERY_ALIASES = {
    "icon": "n/i",
    "metadata.status": "n/s",
    "metadata.language": "s/p",
    "metadata.languages": "s/s",
    "origin.tags": "t",
    "origin.metadata": "m",
    "origin.path": "p",
    "origin.source-id": "u/s",
    "classification.labels": "l",
    "entities": "e",
    "field": "f",
    "field-values": "fg",
    "generated.data-augmentation": "g/da",
}


def translate_alias_label(label: str) -> str:
    parts = label.split("/")
    if len(parts) > 1 and parts[1] in LABEL_QUERY_ALIASES:
        return "/".join(["", LABEL_QUERY_ALIASES[parts[1]], *parts[2:]])
    return label


class FilterExpression(BaseModel):
    """Filter expression (reference: nucliadb_models/filters.py
    FilterExpression). Two accepted shapes:

    - RICH (the reference's public model): ``field`` (typed atom tree —
      and/or/not over {"prop": resource|field|keyword|created|modified|
      label|resource_mimetype|field_mimetype|entity|language|origin_tag|
      origin_metadata|origin_path|origin_source|origin_collaborator|
      generated|status|resource_field_prefix}), ``paragraph`` (label/kind
      tree), ``key_value`` (eq/gte/lte/contains against KV schemas) and
      ``operator`` choosing how field and paragraph filters combine.
      Subtrees validate strictly at translation (search/filter_expr.py).
    - LEGACY (this build's earlier label tree): literal/all/any/none/not.

    Mixing the two shapes in one expression is rejected.
    """

    # rich form
    field: Optional[dict] = None
    paragraph: Optional[dict] = None
    key_value: Optional[dict] = None
    operator: Optional[str] = None  # "and" (default) | "or"

    # legacy label-tree form
    literal: Optional[str] = None  # a facet/label like /l/set/label
    all_: Optional[list["FilterExpression"]] = Field(default=None, alias="all")
    any_: Optional[list["FilterExpression"]] = Field(default=None, alias="any")
    none: Optional[list["FilterExpression"]] = None
    not_: Optional["FilterExpression"] = Field(default=None, alias="not")

    model_config = {"populate_by_name": True}

    @model_validator(mode="after")
    def _one_shape(self) -> "FilterExpression":
        rich = any(v is not None for v in (self.field, self.paragraph, self.key_value))
        legacy = any(
            v is not None for v in (self.literal, self.all_, self.any_, self.none, self.not_)
        )
        if rich and legacy:
            raise ValueError(
                "filter_expression: cannot mix field/paragraph/key_value with "
                "the legacy literal/all/any/none/not tree"
            )
        if self.operator not in (None, "and", "or"):
            raise ValueError(f"filter_expression: bad operator {self.operator!r}")
        return self

    @property
    def is_rich(self) -> bool:
        return any(
            v is not None for v in (self.field, self.paragraph, self.key_value)
        )


def _apply_security_alias(data: dict) -> None:
    """Reference RequestSecurity {groups: [...]} -> security_groups.

    STRICT: silently ignoring a malformed security object would return
    results the caller should not see, so anything but the documented
    shape raises (-> 422)."""
    sec = data.pop("security", None)
    if sec is None:
        return
    if not isinstance(sec, dict) or set(sec) - {"groups"}:
        raise ValueError(f"invalid security: {sec!r}")
    groups = sec.get("groups", [])
    if not isinstance(groups, list) or any(not isinstance(g, str) for g in groups):
        raise ValueError(f"invalid security: {sec!r}")
    if groups:
        data.setdefault("security_groups", groups)


class FindRequest(BaseModel):
    """Hybrid retrieval request. Accepts the reference's spellings too:
    ``min_score`` (float or {"bm25", "semantic"}) and ``page_number``/
    ``page_size`` (legacy /search paging) are normalized in a pre-validator
    so payloads written for nucliadb work unchanged."""

    @model_validator(mode="before")
    @classmethod
    def _reference_aliases(cls, data):
        if not isinstance(data, dict):
            return data
        ms = data.pop("min_score", None)
        if isinstance(ms, dict):
            data.setdefault("min_score_bm25", ms.get("bm25"))
            data.setdefault("min_score_semantic", ms.get("semantic"))
        elif isinstance(ms, str):
            # pydantic-style numeric coercion: honor "0.5" rather than
            # silently discarding the threshold
            try:
                data.setdefault("min_score_semantic", float(ms))
            except ValueError:
                raise ValueError(f"invalid min_score: {ms!r}")
        elif isinstance(ms, (int, float)) and not isinstance(ms, bool):
            data.setdefault("min_score_semantic", ms)
        elif ms is not None:
            raise ValueError(f"invalid min_score: {ms!r}")
        if "page_size" in data:
            data.setdefault("top_k", data.pop("page_size"))
        if "page_number" in data:
            data.setdefault(
                "offset", int(data.pop("page_number")) * int(data.get("top_k", 20))
            )
        _apply_security_alias(data)
        sort = data.pop("sort", None)
        if isinstance(sort, dict):  # reference SortOptions {field, order}
            data.setdefault("sort_field", sort.get("field"))
            data.setdefault("sort_order", sort.get("order", "desc"))
        elif isinstance(sort, str):  # bare field name spelling
            data.setdefault("sort_field", sort)
        elif sort is not None:
            raise ValueError(f"invalid sort: {sort!r}")
        return data

    query: str = ""
    features: list[SearchFeature] = Field(
        default_factory=lambda: [SearchFeature.KEYWORD, SearchFeature.SEMANTIC]
    )
    vector: Optional[list[float]] = None
    vectorset: str = ""
    top_k: int = 20
    min_score_semantic: Optional[float] = None
    min_score_bm25: Optional[float] = None
    filter_expression: Optional[FilterExpression] = None
    # legacy facet filter strings, AND semantics (parity: the old `filters`
    # param, query_parser/old_filters.py; alias prefixes are translated)
    filters: list[str] = Field(default_factory=list)
    # restrict by paragraph-key prefix: "{rid}" scopes to a resource,
    # "{rid}/{field}" to one field (parity: FindRequest.fields)
    fields: list[str] = Field(default_factory=list)
    # restrict to resources by uuid (parity: FindRequest.resource_filters)
    resource_filters: list[str] = Field(default_factory=list)
    security_groups: Optional[list[str]] = None
    highlight: bool = False
    show_hidden: bool = False
    rank_fusion: str = "rrf"  # rrf | weighted
    reranker: str = "noop"  # noop | predict (model rerank over a 5x window)
    # detect KB entities in the query and AND an OR-filter over their
    # /e/{group}/{value} labels (parity: find autofilter + autofilters echo)
    autofilter: bool = False
    # fulltext-block ordering + facet counting (parity: /search sort/faceted)
    sort_field: Optional[str] = None  # created | modified
    sort_order: str = "desc"
    faceted: list[str] = Field(default_factory=list)
    keyword_boost: float = 1.0
    semantic_boost: float = 1.0
    with_synonyms: bool = False  # expand the keyword query with KB synonyms
    offset: int = 0  # pagination offset over the fused ranking
    search_after: Optional[str] = None  # opaque cursor from a previous page
    # True returns identical-vector duplicates; False (the reference
    # default) collapses them (Fssc dedup, nidx_vector searcher.rs:150-199)
    with_duplicates: bool = False
    # date windows (unix seconds or ISO-8601 strings; parity:
    # range_creation_* / range_modification_* search params)
    range_creation_start: Optional[Union[float, str]] = None
    range_creation_end: Optional[Union[float, str]] = None
    range_modification_start: Optional[Union[float, str]] = None
    range_modification_end: Optional[Union[float, str]] = None
    # per-result resource serialization (parity: the `show` search param —
    # "basic" adds timestamps/labels/icon, "values" full field values,
    # "relations" usergenerated relations)
    show: list[str] = Field(default_factory=list)
    # return per-phase timings on the response (parity: debug mode)
    debug: bool = False


class FindResourceData(BaseModel):
    """Extra resource serialization attached per `show` options."""

    created: Optional[float] = None
    modified: Optional[float] = None
    icon: str = ""
    labels: list[str] = Field(default_factory=list)
    texts: dict[str, "TextFieldPayload"] = Field(default_factory=dict)
    links: dict[str, "LinkFieldPayload"] = Field(default_factory=dict)
    usergenerated_relations: list["RelationPayload"] = Field(default_factory=list)


class FindParagraph(BaseModel):
    score: float
    score_type: str  # BM25 | VECTOR | BOTH
    order: int
    text: str = ""
    id: str
    labels: list[str] = Field(default_factory=list)
    position: dict[str, Any] = Field(default_factory=dict)
    fuzzy_result: bool = False
    is_a_match: bool = False


class FindField(BaseModel):
    paragraphs: dict[str, FindParagraph] = Field(default_factory=dict)


class FindResource(BaseModel):
    id: str
    title: str = ""
    summary: str = ""
    fields: dict[str, FindField] = Field(default_factory=dict)
    # populated per the request's `show` options
    data: Optional[FindResourceData] = None


class Relation(BaseModel):
    relation: str
    label: str = ""
    from_value: str = ""
    to_value: str = ""
    metadata: dict[str, Any] = Field(default_factory=dict)


class KnowledgeboxFindResults(BaseModel):
    resources: dict[str, FindResource] = Field(default_factory=dict)
    relations: list[Relation] = Field(default_factory=list)
    total: int = 0
    page_size: int = 20
    next_page: bool = False
    best_matches: list[str] = Field(default_factory=list)
    min_score_semantic: float = 0.0
    min_score_bm25: float = 0.0
    next_cursor: Optional[str] = None  # pass back as search_after
    autofilters: list[str] = Field(default_factory=list)  # applied entity filters
    fulltext: Optional["FulltextResults"] = None  # feature "fulltext"
    # per-phase seconds, present when the request set debug=true (parity:
    # the reference's debug/audit request metrics, search/search/metrics.py)
    timings: Optional[dict[str, float]] = None


class FulltextHit(BaseModel):
    rid: str
    field: str
    score: float


class FulltextResults(BaseModel):
    """Field-level BM25 results (parity: /search fulltext block — document
    hits from the text index, with facet counts when requested)."""

    results: list[FulltextHit] = Field(default_factory=list)
    total: int = 0
    facets: dict[str, dict[str, int]] = Field(default_factory=dict)


class SuggestRequest(BaseModel):
    query: str
    features: list[str] = Field(default_factory=lambda: ["paragraph", "entities"])
    top_k: int = 10
    # label filtering over suggested paragraphs (parity: suggest filters /
    # filter_expression in SuggestRequest; alias prefixes translated)
    filter_expression: Optional[FilterExpression] = None
    filters: list[str] = Field(default_factory=list)


class SuggestedParagraph(BaseModel):
    id: str
    text: str = ""
    score: float = 0.0
    rid: str = ""
    field: str = ""


class SuggestResponse(BaseModel):
    paragraphs: list[SuggestedParagraph] = Field(default_factory=list)
    entities: list[str] = Field(default_factory=list)


class CatalogRequest(BaseModel):
    query: str = ""
    filter_expression: Optional[FilterExpression] = None
    # legacy facet filter strings, AND semantics (alias prefixes translated)
    filters: list[str] = Field(default_factory=list)
    range_creation_start: Optional[Union[float, str]] = None
    range_creation_end: Optional[Union[float, str]] = None
    range_modification_start: Optional[Union[float, str]] = None
    range_modification_end: Optional[Union[float, str]] = None
    faceted: list[str] = Field(default_factory=list)
    page_number: int = 0
    page_size: int = 20
    order_by: str = "created"
    order_desc: bool = True
    # True: only hidden resources; False: only visible; None: all
    # (parity: catalog.py hidden filter over LABEL_HIDDEN)
    hidden: Optional[bool] = None


class CatalogResource(BaseModel):
    id: str
    title: str = ""
    labels: list[str] = Field(default_factory=list)
    created: float = 0.0
    modified: float = 0.0


class CatalogResponse(BaseModel):
    resources: list[CatalogResource] = Field(default_factory=list)
    total: int = 0
    facets: dict[str, dict[str, int]] = Field(default_factory=dict)


class GraphSearchPayload(BaseModel):
    """Single-hop path query payload (reference: /graph endpoint models)."""

    source_value: Optional[str] = None
    source_type: Optional[str] = None
    relation_label: Optional[str] = None
    target_value: Optional[str] = None
    target_type: Optional[str] = None
    fuzzy: bool = False
    undirected: bool = False
    top_k: int = 50
    # semantic node matching through the predict seam (parity: the semantic
    # graph path — node-vector results extend the matched-node set,
    # nidx_relation graph_query_parser.rs VectorQueryResults)
    query: Optional[str] = None
    semantic: bool = False
    # resource constraints (parity: BaseGraphSearchRequest security +
    # show_hidden — the boolean-expression mode already honors them; the
    # flat payload must too or it becomes a security bypass)
    security: Optional[dict] = None  # {"groups": [...]}
    show_hidden: bool = False


class GraphPathResult(BaseModel):
    source: str
    source_type: str = ""
    source_group: str = ""
    relation: str = ""
    label: str = ""
    target: str = ""
    target_type: str = ""
    target_group: str = ""
    score: Optional[float] = None
    # {rid}/{field_type}/{field_id} the path was extracted from
    # (parity: graph responses PathMetadata.field_id)
    field_id: Optional[str] = None


class GraphSearchResponse(BaseModel):
    paths: list[GraphPathResult] = Field(default_factory=list)


class GraphNodeResult(BaseModel):
    """Distinct node from /graph/nodes (parity: responses.GraphNode)."""

    value: str
    type: str = ""
    group: str = ""
    score: Optional[float] = None


class GraphNodesResponse(BaseModel):
    nodes: list[GraphNodeResult] = Field(default_factory=list)


class GraphRelationResult(BaseModel):
    """Distinct relation from /graph/relations (responses.GraphRelation)."""

    label: str
    type: str = ""
    score: Optional[float] = None


class GraphRelationsResponse(BaseModel):
    relations: list[GraphRelationResult] = Field(default_factory=list)


class ChatContextMessage(BaseModel):
    author: str = "USER"  # USER | NUCLIA
    text: str


class AskRequest(BaseModel):
    """RAG request. Reference spellings accepted: ``prompt`` may be the
    CustomPrompt object ({"system", "user"}) and ``min_score`` aliases as in
    FindRequest."""

    @model_validator(mode="before")
    @classmethod
    def _reference_aliases(cls, data):
        if not isinstance(data, dict):
            return data
        p = data.get("prompt")
        if isinstance(p, dict):
            parts = [p.get("system", ""), p.get("user", "")]
            data["prompt"] = "\n".join(s for s in parts if s)
        _apply_security_alias(data)
        return data

    query: str
    vector: Optional[list[float]] = None
    vectorset: str = ""
    top_k: int = 10
    filter_expression: Optional[FilterExpression] = None
    security_groups: Optional[list[str]] = None
    prompt: str = ""
    # conversation continuity + caller-supplied grounding (parity:
    # AskRequest chat_history / extra_context)
    chat_history: list[ChatContextMessage] = Field(default_factory=list)
    extra_context: list[str] = Field(default_factory=list)
    citations: bool = True
    generative_model: str = ""
    # context-building strategies (parity: rag_strategies; names follow the
    # reference: full_resource widens hits to whole fields (count param),
    # neighbouring_paragraphs adds adjacent paragraphs (before/after),
    # field_extension attaches named fields, conversation surrounds message
    # hits with neighbours (max_messages/full), hierarchy prefixes
    # title/summary, metadata_extension appends origin/labels, graph[_beta]
    # adds entity triples from the relation index. Entries are either bare
    # names or the reference's parameterized objects {"name": ..., params}.
    rag_strategies: list[Union[str, dict]] = Field(default_factory=list)
    # extra retrievals whose contexts prepend the main one, strongest weight
    # first (parity: ask prequeries, chat/ask.py parse_prequeries)
    prequeries: list["PreQuery"] = Field(default_factory=list)
    # restrict retrieval to resource/field key prefixes (parity: the
    # resource-scoped /resource/{rid}/ask route scopes retrieval to rid)
    fields: list[str] = Field(default_factory=list)
    # retrieval legs for the grounding find (parity: AskRequest.features)
    features: list[SearchFeature] = Field(
        default_factory=lambda: [SearchFeature.KEYWORD, SearchFeature.SEMANTIC]
    )
    # generation knobs passed through the predict seam (parity:
    # AskRequest.max_tokens / answer_json_schema; without a generative
    # engine the json schema is ignored)
    max_tokens: int = 0
    answer_json_schema: Optional[dict] = None


class PreQuery(BaseModel):
    request: FindRequest
    weight: float = 1.0


class AskResponse(BaseModel):
    answer: str
    status: str = "success"
    rephrased_query: Optional[str] = None
    retrieval: Optional[KnowledgeboxFindResults] = None
    citations: dict[str, list[str]] = Field(default_factory=dict)


# ---- raw retrieval (parity: search/api/v1/retrieve.py +
# nucliadb_models/retrieval.py — text-block matches with a score history,
# no resource hydration) -------------------------------------------------


class RetrievalQuery(BaseModel):
    """Per-leg query spec. `keyword`/`semantic` select the legs; a plain
    string body selects both with the same text (RawQuery in the
    reference)."""

    keyword: Optional[str] = None
    semantic: Optional[str] = None
    vector: Optional[list[float]] = None  # pre-embedded semantic query


class RetrievalRequest(BaseModel):
    query: Union[str, RetrievalQuery]
    top_k: int = Field(default=20, gt=0, le=500)
    filter_expression: Optional[FilterExpression] = None
    security_groups: Optional[list[str]] = None
    fields: list[str] = Field(default_factory=list)
    rank_fusion: str = "rrf"  # rrf | weighted
    reranker: Optional[str] = None  # noop | predict
    vectorset: str = ""


class RetrievalScore(BaseModel):
    score: float
    source: str  # index | rank_fusion | reranker
    type: str  # keyword | semantic | rrf | wCombSUM | reranker


class RetrievalScores(BaseModel):
    value: float
    source: str
    type: str
    history: list[RetrievalScore] = Field(default_factory=list)


class RetrievalMatchMetadata(BaseModel):
    field_labels: list[str] = Field(default_factory=list)
    paragraph_labels: list[str] = Field(default_factory=list)
    position: dict[str, Any] = Field(default_factory=dict)
    is_a_match: bool = False


class RetrievalMatch(BaseModel):
    id: str  # paragraph id "{rid}/{field}/{start}-{end}"
    text: str = ""
    score: RetrievalScores
    metadata: RetrievalMatchMetadata = Field(default_factory=RetrievalMatchMetadata)


class RetrievalResponse(BaseModel):
    matches: list[RetrievalMatch] = Field(default_factory=list)

"""Field-level full-text (document) index: BM25 + facets + prefilter.

Counterpart of ``nucliadb_tpu/index/text/__init__.py`` on the port's text
engine; the searcher takes an explicit torch ``device``.

Parity surface with the reference's nidx_text crate
(nidx_text/src/lib.rs:130-240, schema.rs:68-96): one document per field with
uuid, field id, text, created/modified, status, facets and security groups;
BM25 search, faceted/filtered listing, and the **prefilter** stage that
turns a security + label filter into a PrefilterResult consumed by the
other indexes (prefilter.rs:37-42).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Optional, Sequence

import numpy as np
import torch

from ...models.internal import ResourceDoc, ResourceStatus
from ...query_language import BooleanExpression, evaluate_bitset
from ...types import (
    FieldId,
    OpenIndexMetadata,
    PrefilterResult,
    SegmentMetadata,
)
from ..paragraph import advanced_query_mask
from ..text_engine import DeviceTextEngine, TextHit, TextQuery
from ..text_engine.builder import DocEntry, build_segment, merge_text_segments, open_text_segment

STATUS_CODE = {s.value: i for i, s in enumerate(ResourceStatus)}
FACET_PUBLIC = "/g/public"
GROUP_PREFIX = "/g/s/"


def field_key(rid: str, field_id: str) -> str:
    return f"{rid}/{field_id}"


class TextIndexer:
    """Builds text segments from resources (one doc per field)."""

    def index_resource(
        self, resource: ResourceDoc, output_dir: str
    ) -> Optional[SegmentMetadata]:
        if resource.skip_texts:
            return None
        docs: list[DocEntry] = []
        security_facets: list[str]
        if resource.security is None or not resource.security.access_groups:
            security_facets = [FACET_PUBLIC]
        else:
            security_facets = [
                GROUP_PREFIX + g for g in resource.security.access_groups
            ]
        status_label = f"/n/s/{resource.status.value}"
        for fid, info in resource.texts.items():
            # /f/{type} facet per doc (parity: the text schema's `field`
            # facet — enables "/field/a"-style filters via the query alias
            # table, and catalog's title-only query matching)
            field_type_facet = f"/f/{fid.split('/', 1)[0]}"
            facets = sorted(
                set(resource.labels) | set(info.labels) | set(security_facets)
                | {status_label, field_type_facet}
            )
            docs.append(
                DocEntry(
                    key=field_key(resource.resource_id, fid),
                    text=info.text,
                    facets=facets,
                    attrs={"field": fid, "rid": resource.resource_id},
                    columns={
                        "created": int(resource.created),
                        "modified": int(resource.modified),
                        "status": STATUS_CODE.get(resource.status.value, 0),
                    },
                )
            )
        if not docs:
            return None
        # store_text: persist the extracted field text in the segment so the
        # searcher can serve get_fields_text / ExtractedTexts without blob
        # storage (parity: tantivy stored `text` field, nidx_text schema.rs)
        return build_segment(output_dir, docs, kind="text", store_text=True)

    def deletions_for_resource(self, resource: ResourceDoc) -> list[str]:
        if resource.texts_to_delete:
            return [
                field_key(resource.resource_id, fid) for fid in resource.texts_to_delete
            ]
        return [resource.resource_id + "/"]

    def merge(self, open_index: OpenIndexMetadata, output_dir: str) -> SegmentMetadata:
        return merge_text_segments(output_dir, open_index, kind="text")


@dataclass
class DocumentSearchRequest:
    """Parity: nodereader DocumentSearchRequest (nidx_text search surface)."""

    query: str = ""
    top_k: int = 20
    filter: Optional[BooleanExpression] = None
    security_groups: Optional[list[str]] = None  # None = no security check
    only_faceted: bool = False
    faceted: list[str] = dc_field(default_factory=list)  # facet prefixes to count
    order_by: Optional[str] = None  # "created" | "modified"
    order_desc: bool = True
    min_score: Optional[float] = None
    all_terms: bool = False
    count_resources: bool = False  # totals/facets at resource (not field) level
    # extra Must() query in tantivy grammar (nodereader
    # SearchRequest.advanced_query on the document leg)
    advanced_query: Optional[str] = None
    range_creation: Optional[tuple] = None  # (lo, hi) unix seconds
    range_modification: Optional[tuple] = None
    key_prefixes: Optional[list[str]] = None  # fields/resource_filters scope
    field_filter: Optional[PrefilterResult] = None  # prefilter handoff


@dataclass
class DocumentHit:
    key: str
    rid: str
    field: str
    score: float


@dataclass
class DocumentSearchResponse:
    hits: list[DocumentHit]
    total: int
    facet_counts: dict[str, dict[str, int]]



def _date_range_mask(engine, range_creation, range_modification) -> "Optional[np.ndarray]":
    """Boolean doc mask for created/modified windows (None = no constraint)."""
    mask = None
    for column, window in (("created", range_creation),
                           ("modified", range_modification)):
        if window is None:
            continue
        col = engine.columns.get(column)
        if col is None:
            continue
        lo, hi = window
        m = np.ones(engine.n_docs, dtype=bool)
        if lo is not None:
            m &= col >= lo
        if hi is not None:
            m &= col <= hi
        mask = m if mask is None else (mask & m)
    return mask


class TextSearcher:
    def __init__(
        self,
        open_index: OpenIndexMetadata,
        prev: "TextSearcher | None" = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        segments = [
            (open_text_segment(m.path), seq) for m, seq in open_index.segments()
        ]
        self.engine = DeviceTextEngine(
            segments, open_index.deletions(),
            prev=prev.engine if prev is not None else None,
            device=device,
        )

    def _security_mask(self, groups: Optional[list[str]]) -> Optional[np.ndarray]:
        """Docs visible to the given access groups (public always visible).

        Parity: nidx_text schema groups_public / groups_with_access
        (schema.rs:68-96) and the security part of prefiltering.
        """
        if groups is None:
            return None
        mask = np.zeros(self.engine.n_docs, dtype=bool)
        mask[self.engine.facet_postings(FACET_PUBLIC)] = True
        for group in groups:
            mask[self.engine.facet_postings(GROUP_PREFIX + group)] = True
        return mask

    def search(self, request: DocumentSearchRequest) -> DocumentSearchResponse:
        extra_mask = self._security_mask(request.security_groups)
        dmask = _date_range_mask(
            self.engine, request.range_creation, request.range_modification
        )
        if dmask is not None:
            extra_mask = dmask if extra_mask is None else (extra_mask & dmask)
        ff = request.field_filter
        if ff is not None and not ff.is_all:
            # prefilter handoff (field/json filters) restricts the document
            # leg too, like the paragraph/vector legs
            fmask = np.zeros(self.engine.n_docs, dtype=bool)
            if not ff.is_none:
                fmask[
                    self.engine.key_prefix_postings(
                        [f.as_key_prefix() for f in ff.fields]
                    )
                ] = True
            extra_mask = fmask if extra_mask is None else (extra_mask & fmask)
        if request.advanced_query:
            amask = advanced_query_mask(self.engine, request.advanced_query)
            extra_mask = amask if extra_mask is None else (extra_mask & amask)
        q = TextQuery(
            text=request.query,
            top_k=max(request.top_k, 1),
            only_faceted=request.only_faceted or not request.query.strip(),
            filter=request.filter,
            extra_mask=extra_mask,
            min_score=request.min_score,
            all_terms=request.all_terms,
            key_prefixes=request.key_prefixes,
        )
        hits, matched = self.engine.search(q)
        if request.order_by in ("created", "modified"):
            col = self.engine.columns.get(request.order_by)
            if col is not None:
                dids = np.nonzero(matched)[0]
                order = np.argsort(col[dids], kind="stable")
                if request.order_desc:
                    order = order[::-1]
                dids = dids[order][: request.top_k]
                hits = [
                    TextHit(
                        key=self.engine.keys[d],
                        score=0.0,
                        doc_id=int(d),
                        attrs=self.engine.attrs[d],
                    )
                    for d in dids
                ]
        def _rid(did: int) -> str:
            attrs = self.engine.attrs[did]
            return attrs.get("rid") or self.engine.keys[did].split("/", 1)[0]

        facet_counts: dict[str, dict[str, int]] = {}
        for facet_prefix in request.faceted:
            prefix = facet_prefix.rstrip("/")
            counts: dict[str, int] = {}
            for facet, postings in self.engine.facets.items():
                if facet == prefix or facet.startswith(prefix + "/"):
                    if request.count_resources:
                        c = len({_rid(int(d)) for d in postings if matched[d]})
                    else:
                        c = int(matched[postings].sum())
                    if c:
                        counts[facet] = c
            facet_counts[facet_prefix] = counts
        if request.count_resources:
            total = len({_rid(int(d)) for d in np.nonzero(matched)[0]})
        else:
            total = int(matched.sum())
        out = [
            DocumentHit(
                key=h.key,
                rid=h.attrs.get("rid", h.key.split("/", 1)[0]),
                field=h.attrs.get("field", ""),
                score=h.score,
            )
            for h in hits
        ]
        return DocumentSearchResponse(
            hits=out, total=total, facet_counts=facet_counts
        )

    def get_fields_text(self, keys: Sequence[str]) -> dict[str, Optional[str]]:
        """Stored extracted text per field key ("rid/fid"). None for keys
        absent, deleted, or indexed before stored text existed (parity:
        TextSearcher::get_fields_text, nidx_text/src/lib.rs:130-240)."""
        import bisect

        out: dict[str, Optional[str]] = {}
        eng = self.engine
        for key in keys:
            text: Optional[str] = None
            # per-segment runs (the concatenated key list is only sorted
            # within each segment); the LAST alive match wins — segment
            # order is seq-ascending, so it is the freshest copy
            for run_lo, run_hi in eng.seg_bounds:
                gid = bisect.bisect_left(eng.keys, key, run_lo, run_hi)
                if gid < run_hi and eng.keys[gid] == key and eng.alive[gid]:
                    text = eng.stored_text(gid)
            out[key] = text
        return out

    def prefilter(
        self,
        filter: Optional[BooleanExpression] = None,
        security_groups: Optional[list[str]] = None,
        range_creation=None,
        range_modification=None,
    ) -> PrefilterResult:
        """Turn security + label filters into a FieldId set for other indexes.

        Parity: nidx_text prefilter (prefilter.rs:37-42, reader.rs): returns
        All when nothing filters, None when nothing matches, Some(fields)
        otherwise.
        """
        if (
            filter is None and security_groups is None
            and range_creation is None and range_modification is None
        ):
            return PrefilterResult.all()
        mask = self.engine.alive.copy()
        dmask = _date_range_mask(self.engine, range_creation, range_modification)
        if dmask is not None:
            mask &= dmask
        if filter is not None:
            mask &= evaluate_bitset(filter, self.engine.n_docs, self.engine._resolve_atom)
        sec = self._security_mask(security_groups)
        if sec is not None:
            mask &= sec
        # emptiness check FIRST: numpy's all() on a zero-doc index is
        # vacuously True, which returned All and bypassed security/field
        # filters for the other index legs
        if not mask.any():
            return PrefilterResult.none()
        if mask.all():
            return PrefilterResult.all()
        fields = []
        for did in np.nonzero(mask)[0]:
            attrs = self.engine.attrs[did]
            rid = attrs.get("rid") or self.engine.keys[did].split("/", 1)[0]
            fid = attrs.get("field") or self.engine.keys[did].split("/", 1)[1]
            fields.append(FieldId(resource_id=rid, field_id=fid))
        return PrefilterResult.some(fields)

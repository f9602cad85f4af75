"""Vector index facade: VectorIndexer, VectorSearchRequest, VectorSearcher.

Counterpart of ``nucliadb_tpu/index/vector/__init__.py``: the indexer the
shard indexer and the merge worker call, and the searcher the shard
searcher calls for the semantic leg. The compute runs through the port's
device index (``device.py``) on an explicit ``device``: the exact tiers,
int8 codes (with or without the ``pallas`` flag), binary codes (with or
without it), the ``ivf`` and ``hnsw`` strategies, whose centroids and
graph the indexer builds on its ``device``, MULTI cardinality (MaxSim over
one elem per paragraph holding its sentence vectors) and the paged tiers
an ``NDBTPU_VECTOR_ARENA_BUDGET`` selects. While tracing is on,
``VectorSearcher.search`` records the spans ``searcher.mask`` (the
request's mask) and ``searcher.hits`` (every row's ``VectorHit``s).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ...models.internal import ResourceDoc
from ...query_language import (
    BooleanExpression,
    FacetPrefixAtom,
    KeyPrefixAtom,
    LabelAtom,
    evaluate_bitset,
)
from ...telemetry import tracing
from ...types import OpenIndexMetadata, PrefilterResult, SegmentMetadata, Seq, SimpleOpenIndex

from .config import Quantization, Similarity, VectorCardinality, VectorConfig
from .device import DeviceVectorIndex, VectorHit
from .segment import Elem, create_segment, merge_segments, open_segment

# the jax-free request and index types the searcher's API takes are
# re-exported, so a caller of the port needs no import of the JAX package
__all__ = [
    "VectorConfig",
    "Similarity",
    "VectorCardinality",
    "Quantization",
    "VectorIndexer",
    "VectorSearcher",
    "VectorSearchRequest",
    "VectorHit",
    "Elem",
    "create_segment",
    "LabelAtom",
    "FacetPrefixAtom",
    "KeyPrefixAtom",
    "PrefilterResult",
    "Seq",
    "SimpleOpenIndex",
]

# resources marked hidden get their segments tagged (parity:
# nidx_vector SEGMENT_TAGS / hidden-resource support, searcher.rs:206-219)
TAG_HIDDEN = "hidden"


class VectorIndexer:
    """Builds vector segments from resources; merges segments. A flagged
    config's graph or centroids are built on ``device``."""

    def __init__(self, config: VectorConfig, *, device: "str | torch.device" = "cuda"):
        self.config = config
        self.device = device

    def resource_elems(self, resource: ResourceDoc, vectorset: str) -> list[Elem]:
        elems: list[Elem] = []
        for field_id, paragraphs in resource.paragraphs.items():
            field_labels = resource.labels + (
                resource.texts[field_id].labels if field_id in resource.texts else []
            )
            for pid, para in paragraphs.items():
                sentences = para.vectorsets_sentences.get(vectorset, {})
                if not sentences:
                    continue
                labels = field_labels + para.labels
                meta = {
                    "field": field_id,
                    "split": para.split,
                    "position": {
                        "start": para.position.start if para.position else para.start,
                        "end": para.position.end if para.position else para.end,
                        "page_number": para.position.page_number if para.position else 0,
                    },
                }
                if self.config.cardinality == VectorCardinality.MULTI:
                    # one elem per paragraph, keyed by it: its sentence vectors
                    vecs = np.stack(
                        [np.asarray(s.vector, np.float32) for s in sentences.values()]
                    )
                    elems.append(Elem(key=pid, vectors=vecs, labels=labels, metadata=meta))
                    continue
                for vkey, sentence in sentences.items():
                    elems.append(
                        Elem(
                            key=vkey,
                            vectors=np.asarray(sentence.vector, np.float32).reshape(1, -1),
                            labels=labels,
                            metadata=meta,
                        )
                    )
        return elems

    def index_resource(
        self,
        resource: ResourceDoc,
        vectorset: str,
        output_dir: str,
        *,
        hidden: bool = False,
    ) -> Optional[SegmentMetadata]:
        """Build one segment from one resource (None if nothing to index)."""
        elems = self.resource_elems(resource, vectorset)
        if not elems:
            return None
        tags = {TAG_HIDDEN} if hidden else set()
        return create_segment(output_dir, elems, self.config, tags=tags, device=self.device)

    def deletions_for_resource(self, resource: ResourceDoc, vectorset: str) -> list[str]:
        """Key prefixes to delete when this resource (re)arrives: the
        resource-wide prefixes plus the vectorset-scoped ones
        (nidx_vector/src/lib.rs:88-94)."""
        prefixes = list(resource.vectors_to_delete_in_all_vectorsets)
        prefixes += resource.vector_prefixes_to_delete.get(vectorset, [])
        return prefixes

    def merge(self, open_index: OpenIndexMetadata, output_dir: str) -> SegmentMetadata:
        return merge_segments(output_dir, open_index, self.config, device=self.device)


@dataclass
class VectorSearchRequest:
    """One vector query against an index.

    ``vectors`` is [D], [B, D] or [B, M, D] (multivector MaxSim).
    ``filter`` combines label filters; ``field_filter`` is the prefilter's
    FieldId handoff.
    """

    vectors: np.ndarray
    top_k: int = 10
    filter: Optional[BooleanExpression] = None
    field_filter: PrefilterResult = field(default_factory=PrefilterResult.all)
    # boundary-aware key-prefix restriction (the /find `fields=` filter)
    key_prefixes: Optional[list[str]] = None
    min_score: Optional[float] = None
    include_hidden: bool = False
    # False (the reference default) drops results whose vector repeats a
    # higher-ranked result's (Fssc dedup)
    with_duplicates: bool = False
    # how ``filter`` combines with the ``field_filter`` prefilter: "or"
    # matches EITHER side; only meaningful when both are present
    filter_operator: str = "and"


class VectorSearcher:
    """Open segments of one vector index; answers queries on ``device``."""

    def __init__(
        self,
        config: VectorConfig,
        open_index: OpenIndexMetadata,
        prev: "VectorSearcher | None" = None,
        *,
        device: "str | torch.device" = "cuda",
    ):
        segments = [(open_segment(m.path), seq) for m, seq in open_index.segments()]
        self.index = DeviceVectorIndex(
            config, segments, open_index.deletions(),
            prev=prev.index if prev is not None else None,
            device=device,
        )
        self.config = config

    def _resolve_atom(self, atom) -> np.ndarray:
        if isinstance(atom, LabelAtom):
            return self.index.label_postings(atom.label)
        if isinstance(atom, FacetPrefixAtom):
            chunks = [
                pids
                for label, pids in self.index.labels.items()
                if label == atom.facet or label.startswith(atom.facet.rstrip("/") + "/")
            ]
            return np.unique(np.concatenate(chunks)) if chunks else np.zeros(0, np.int32)
        if isinstance(atom, KeyPrefixAtom):
            return self.index.key_prefix_postings(atom.prefixes)
        raise TypeError(f"unsupported filter atom for vector index: {atom!r}")

    def _build_mask(self, request: VectorSearchRequest) -> Optional[np.ndarray]:
        idx = self.index
        mask: Optional[np.ndarray] = None
        if request.filter is not None:
            mask = evaluate_bitset(request.filter, idx.n_para, self._resolve_atom)
        if not request.field_filter.is_all:
            field_mask = np.zeros(idx.n_para, dtype=bool)
            if not request.field_filter.is_none:
                prefixes = [f.as_key_prefix() for f in request.field_filter.fields]
                field_mask[idx.key_prefix_postings(prefixes)] = True
            if mask is not None and request.filter_operator == "or":
                # FilterOperator::Or — a paragraph passes matching EITHER
                # the prefilter's fields or the paragraph filter
                mask = mask | field_mask
            else:
                mask = field_mask if mask is None else (mask & field_mask)
        if request.key_prefixes:
            kp_mask = np.zeros(idx.n_para, dtype=bool)
            kp_mask[idx.key_prefix_postings(list(request.key_prefixes))] = True
            mask = kp_mask if mask is None else (mask & kp_mask)
        if not request.include_hidden and any(TAG_HIDDEN in tags for tags in idx.seg_tags):
            allowed = [i for i, tags in enumerate(idx.seg_tags) if TAG_HIDDEN not in tags]
            tag_mask = idx.segment_tag_mask(allowed)[: idx.n_para]
            mask = tag_mask if mask is None else (mask & tag_mask)
        return mask

    def search(self, request: VectorSearchRequest) -> list[list[VectorHit]]:
        q = np.asarray(request.vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[-1] != self.config.dimension:
            raise ValueError(
                f"query vector dimension {q.shape[-1]} does not match the "
                f"vectorset dimension {self.config.dimension}"
            )
        if q.ndim == 3 and self.config.cardinality != VectorCardinality.MULTI:
            raise ValueError("multivector query against a single-vector index")
        with tracing.span("searcher.mask"):
            mask = self._build_mask(request)
        scores, ids = self.index.search(
            q, request.top_k, para_mask=mask, min_score=request.min_score,
            with_duplicates=request.with_duplicates,
        )
        with tracing.span("searcher.hits"):
            return [self.index.hits(scores[b], ids[b]) for b in range(scores.shape[0])]

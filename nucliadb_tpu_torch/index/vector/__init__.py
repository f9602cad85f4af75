"""Vector index facade: VectorSearchRequest + VectorSearcher.

Counterpart of ``nucliadb_tpu/index/vector/__init__.py:121-230``, the
searcher the shard searcher calls for the semantic leg. The compute runs
through the port's device index (``device.py``) on an explicit ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from nucliadb_tpu.query_language import (
    BooleanExpression,
    FacetPrefixAtom,
    KeyPrefixAtom,
    LabelAtom,
    evaluate_bitset,
)
from nucliadb_tpu.types import OpenIndexMetadata, PrefilterResult, Seq, SimpleOpenIndex

from .config import Quantization, Similarity, VectorCardinality, VectorConfig
from .device import DeviceVectorIndex, VectorHit
from .segment import Elem, create_segment, open_segment

# the jax-free request and index types the searcher's API takes are
# re-exported, so a caller of the port needs no import of the JAX package
__all__ = [
    "VectorConfig",
    "Similarity",
    "VectorCardinality",
    "Quantization",
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

# resources marked hidden get their segments tagged
TAG_HIDDEN = "hidden"


@dataclass
class VectorSearchRequest:
    """One vector query against an index.

    ``vectors`` is [D] or [B, D]. ``filter`` combines label filters;
    ``field_filter`` is the prefilter's FieldId handoff.
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
        mask = self._build_mask(request)
        scores, ids = self.index.search(
            q, request.top_k, para_mask=mask, min_score=request.min_score,
            with_duplicates=request.with_duplicates,
        )
        return [self.index.hits(scores[b], ids[b]) for b in range(scores.shape[0])]

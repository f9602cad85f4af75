"""Core index substrate types.

The port's copy of ``nucliadb_tpu/types.py``, kept verbatim: the port
imports nothing of the JAX package.

TPU-native re-design of the reference's `nidx_types` crate
(reference: nidx/nidx_types/src/lib.rs:21-56, prefilter.rs, query_language.rs):

- ``Seq``: a total order over index operations. Every segment and every
  deletion is recorded at the sequence number of the operation that produced
  it; the visible state of an index is "all ready segments, minus deletions
  with seq greater than the segment's seq".
- ``SegmentMetadata``: description of one immutable segment on disk.
- ``OpenIndexMetadata``: what an index implementation needs to open or merge
  a set of segments (segment list + deletion list, both seq-tagged).
- ``PrefilterResult`` / ``FieldId``: the handoff from the text prefilter to
  the other indexes (reference: nidx/nidx_types/src/prefilter.rs).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterable, Protocol, Sequence


@functools.total_ordering
@dataclass(frozen=True)
class Seq:
    """Total order for index operations (reference: nidx_types/src/lib.rs:21)."""

    value: int

    def __int__(self) -> int:
        return self.value

    def __lt__(self, other: "Seq | int") -> bool:
        return self.value < int(other)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, (Seq, int)):
            return self.value == int(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Seq({self.value})"


class IndexKind(str, Enum):
    """The five index families (reference: nidx/src/indexer.rs:380-419)."""

    VECTOR = "vector"
    TEXT = "text"
    PARAGRAPH = "paragraph"
    RELATION = "relation"
    JSON = "json"


@dataclass(frozen=True)
class FieldId:
    """A (resource, field) pair, the unit the text prefilter selects.

    Reference: nidx_types/src/prefilter.rs — ``field_id=None`` is a
    RESOURCE-granular entry matching every field of the resource (the json
    prefilter's granularity; prefilter.rs to_field_ids + the uuid-direct
    match in nidx_paragraph search_query.rs:106-121). Keys in the vector
    index are prefixed by ``{rid}/{field}`` so a FieldId maps to a key
    prefix.
    """

    resource_id: str
    field_id: "str | None"

    def as_key_prefix(self) -> str:
        if self.field_id is None:
            return f"{self.resource_id}/"
        return f"{self.resource_id}/{self.field_id}"


class PrefilterKind(Enum):
    ALL = "all"
    NONE = "none"
    SOME = "some"


@dataclass(frozen=True)
class PrefilterResult:
    """Result of running the text/json prefilter stage.

    Reference: nidx_types/src/prefilter.rs (PrefilterResult::{All,None,Some}).
    """

    kind: PrefilterKind
    fields: tuple[FieldId, ...] = ()

    @staticmethod
    def all() -> "PrefilterResult":
        return PrefilterResult(PrefilterKind.ALL)

    @staticmethod
    def none() -> "PrefilterResult":
        return PrefilterResult(PrefilterKind.NONE)

    @staticmethod
    def some(fields: Iterable[FieldId]) -> "PrefilterResult":
        return PrefilterResult(PrefilterKind.SOME, tuple(fields))

    @property
    def is_all(self) -> bool:
        return self.kind is PrefilterKind.ALL

    @property
    def is_none(self) -> bool:
        return self.kind is PrefilterKind.NONE

    def intersect(self, other: "PrefilterResult") -> "PrefilterResult":
        """Combine two prefilters (text AND json). Granularities mix: a
        field-granular entry survives when the other side has the exact
        FieldId OR a resource-granular entry for its resource (parity:
        prefilter.rs combine with FilterOperator::And — field sets retained
        by resource membership)."""
        if self.is_none or other.is_none:
            return PrefilterResult.none()
        if self.is_all:
            return other
        if other.is_all:
            return self
        set_a, set_b = set(self.fields), set(other.fields)
        res_a = {f.resource_id for f in self.fields if f.field_id is None}
        res_b = {f.resource_id for f in other.fields if f.field_id is None}
        both: list[FieldId] = []
        for f in self.fields:
            if f.field_id is None:
                if f in set_b:
                    both.append(f)  # resource-granular on both sides
            elif f in set_b or f.resource_id in res_b:
                both.append(f)
        for f in other.fields:
            if f.field_id is not None and f not in set_a and f.resource_id in res_a:
                both.append(f)
        if not both:
            return PrefilterResult.none()
        return PrefilterResult.some(both)

    def union(self, other: "PrefilterResult") -> "PrefilterResult":
        """Combine two prefilters with OR (SearchRequest.filter_operator=OR;
        parity: nidx_types/src/prefilter.rs PrefilterResult::combine with
        FilterOperator::Or — both sides here are field-level sets)."""
        if self.is_all or other.is_all:
            return PrefilterResult.all()
        if self.is_none:
            return other
        if other.is_none:
            return self
        seen = set(self.fields)
        merged = list(self.fields) + [f for f in other.fields if f not in seen]
        return PrefilterResult.some(merged)


@dataclass
class SegmentMetadata:
    """One immutable segment of one index.

    Reference: nidx_types/src/lib.rs:33-51 (SegmentMetadata<T>). The
    ``index_metadata`` payload is index-kind specific (e.g. the vector
    segment records dim/similarity/quantization).
    """

    path: str
    records: int
    tags: frozenset[str] = frozenset()
    index_metadata: dict[str, Any] = field(default_factory=dict)


class OpenIndexMetadata(Protocol):
    """What an index needs to open/merge segments.

    Reference: nidx_types/src/lib.rs:53-56 — yields (SegmentMetadata, Seq)
    pairs plus (deletion_key, Seq) pairs.
    """

    def segments(self) -> Sequence[tuple[SegmentMetadata, Seq]]: ...

    def deletions(self) -> Sequence[tuple[str, Seq]]: ...


@dataclass
class SimpleOpenIndex:
    """Plain-data OpenIndexMetadata used by tests and the merge worker.

    Mirrors the reference's test ``TestOpener`` (nidx_vector/tests/common)
    and the worker's ``MergeInputs`` (nidx/src/worker.rs:100-120).
    """

    segment_list: list[tuple[SegmentMetadata, Seq]] = field(default_factory=list)
    deletion_list: list[tuple[str, Seq]] = field(default_factory=list)

    def segments(self) -> Sequence[tuple[SegmentMetadata, Seq]]:
        return self.segment_list

    def deletions(self) -> Sequence[tuple[str, Seq]]:
        return self.deletion_list

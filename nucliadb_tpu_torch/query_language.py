"""Boolean filter expressions shared by all indexes.

The port's copy of ``nucliadb_tpu/query_language.py``, kept verbatim: the
port imports nothing of the JAX package.

TPU-native re-design of two reference pieces:

- ``nidx_types/src/query_language.rs`` — ``BooleanExpression`` trees built by
  the query planner from the user's filter expression.
- ``nidx_vector/src/inverted_index/formula.rs:17-102`` — the vector index's
  ``Formula`` of ``AtomClause::{Label, KeyPrefixSet}`` combined with
  And/Or/Not, evaluated per segment into a filter bitset.

Here the expression tree is one structure; each index lowers atoms to sorted
posting arrays (numpy int32) and evaluation produces a packed device bitmask,
which the scoring kernels consume directly (filter as an input mask instead of
post-hoc filtering — see SURVEY.md §2.3 "Intra-query parallelism").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Union

import numpy as np

BooleanExpression = Union[
    "LabelAtom", "KeyPrefixAtom", "FacetPrefixAtom",
    "FieldAtom", "KeywordAtom", "DateRangeAtom",
    "And", "Or", "Not",
]


@dataclass(frozen=True)
class LabelAtom:
    """Matches records carrying a label (reference: formula.rs AtomClause::Label)."""

    label: str


@dataclass(frozen=True)
class KeyPrefixAtom:
    """Matches records whose key starts with any of the prefixes.

    Reference: formula.rs AtomClause::KeyPrefixSet — this is how the text
    prefilter's FieldId set reaches the vector index
    (nidx_vector/src/searcher.rs:300-312).
    """

    prefixes: tuple[str, ...]


@dataclass(frozen=True)
class FacetPrefixAtom:
    """Matches records with a facet equal to or under a path (e.g. ``/l/labelset``)."""

    facet: str


@dataclass(frozen=True)
class FieldAtom:
    """Matches documents of a field type, optionally a specific field name.

    Reference: nidx_text search_query.rs filter_to_query Expr::Field —
    a term query on the ``/{type}`` or ``/{type}/{name}`` field facet.
    """

    field_type: str
    field_name: str | None = None


@dataclass(frozen=True)
class KeywordAtom:
    """Matches documents containing a keyword (tokenized; multi-word
    keywords must appear as a consecutive phrase).

    Reference: nidx_text query_io.rs translate_keyword_to_text_query —
    one term -> TermQuery, several -> PhraseQuery.
    """

    keyword: str


@dataclass(frozen=True)
class DateRangeAtom:
    """Matches documents whose created/modified timestamp falls in
    [since, until] (unix seconds, either bound optional).

    Reference: nidx_text search_query.rs Expr::Date ->
    produce_date_range_query over the created/modified date columns.
    """

    column: str  # "created" | "modified"
    since: float | None = None
    until: float | None = None


@dataclass(frozen=True)
class And:
    operands: tuple[BooleanExpression, ...]


@dataclass(frozen=True)
class Or:
    operands: tuple[BooleanExpression, ...]


@dataclass(frozen=True)
class Not:
    operand: BooleanExpression


def and_(*ops: BooleanExpression) -> BooleanExpression:
    flat: list[BooleanExpression] = []
    for op in ops:
        if isinstance(op, And):
            flat.extend(op.operands)
        else:
            flat.append(op)
    return flat[0] if len(flat) == 1 else And(tuple(flat))


def or_(*ops: BooleanExpression) -> BooleanExpression:
    flat: list[BooleanExpression] = []
    for op in ops:
        if isinstance(op, Or):
            flat.extend(op.operands)
        else:
            flat.append(op)
    return flat[0] if len(flat) == 1 else Or(tuple(flat))


def not_(op: BooleanExpression) -> BooleanExpression:
    if isinstance(op, Not):
        return op.operand
    return Not(op)


# An atom resolver maps a leaf atom to the sorted array of matching record ids
# within one segment (the segment's posting lists / key table).
AtomResolver = Callable[[BooleanExpression], np.ndarray]


def evaluate_bitset(
    expr: BooleanExpression | None,
    n_records: int,
    resolver: AtomResolver,
) -> np.ndarray:
    """Evaluate a filter expression to a boolean mask of shape [n_records].

    ``resolver`` is called for each leaf atom and must return the (sorted,
    possibly empty) int array of matching record ids. Returns a bool ndarray;
    callers pack it (``np.packbits`` / device mask) for the kernels.
    """
    mask = np.zeros(n_records, dtype=bool)
    if expr is None:
        mask[:] = True
        return mask
    if isinstance(expr, And):
        mask[:] = True
        for op in expr.operands:
            mask &= evaluate_bitset(op, n_records, resolver)
        return mask
    if isinstance(expr, Or):
        for op in expr.operands:
            mask |= evaluate_bitset(op, n_records, resolver)
        return mask
    if isinstance(expr, Not):
        return ~evaluate_bitset(expr.operand, n_records, resolver)
    ids = resolver(expr)
    if len(ids):
        mask[np.asarray(ids, dtype=np.int64)] = True
    return mask


def evaluate_one(
    expr: BooleanExpression | None, labels, key: str = ""
) -> bool:
    """Evaluate an expression against ONE record's label set + key (used by
    the external-index leg, which post-filters provider hits host-side)."""
    if expr is None:
        return True
    labels = set(labels)

    def resolver(atom) -> list[int]:
        if isinstance(atom, LabelAtom):
            return [0] if atom.label in labels else []
        if isinstance(atom, KeyPrefixAtom):
            return [0] if any(key.startswith(p) for p in atom.prefixes) else []
        if isinstance(atom, FacetPrefixAtom):
            facet = atom.facet.rstrip("/")
            return (
                [0]
                if any(l == facet or l.startswith(facet + "/") for l in labels)
                else []
            )
        raise TypeError(f"unknown atom {atom!r}")

    return bool(evaluate_bitset(expr, 1, resolver)[0])


def evaluate_sets(expr: BooleanExpression | None, universe: frozenset, resolver) -> frozenset:
    """Set-based evaluation (used by host-side planners over small universes)."""
    if expr is None:
        return universe
    if isinstance(expr, And):
        out = universe
        for op in expr.operands:
            out = out & evaluate_sets(op, universe, resolver)
        return out
    if isinstance(expr, Or):
        out: frozenset = frozenset()
        for op in expr.operands:
            out = out | evaluate_sets(op, universe, resolver)
        return out
    if isinstance(expr, Not):
        return universe - evaluate_sets(expr.operand, universe, resolver)
    return frozenset(resolver(expr))

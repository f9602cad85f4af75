"""JSON filter index: typed predicates over flattened JSON paths.

The port's copy of ``nucliadb_tpu/index/json/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity surface with the reference's nidx_json crate
(nidx_json/src/lib.rs:14-70, search.rs, schema.rs): each field's JSON value
is flattened into (path, typed value) pairs; queries are boolean trees of
typed predicates (string eq, number eq/range, bool eq, exists) producing a
document set that joins the text prefilter (PrefilterResult intersection at
the query planner, nidx/src/searcher/shard_search.rs:175-208).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional, Union

import msgpack
import numpy as np

from ...models.internal import ResourceDoc
from ...types import FieldId, OpenIndexMetadata, PrefilterResult, SegmentMetadata, Seq
from ...utils.keys import key_matches_prefix


def flatten_json(value: Any, prefix: str = "") -> list[tuple[str, Any]]:
    out: list[tuple[str, Any]] = []
    if isinstance(value, dict):
        for k, v in value.items():
            out.extend(flatten_json(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(value, list):
        for v in value:
            out.extend(flatten_json(v, prefix))
    else:
        out.append((prefix, value))
    return out


class JsonIndexer:
    def index_resource(
        self, resource: ResourceDoc, output_dir: str
    ) -> Optional[SegmentMetadata]:
        if resource.skip_json or not resource.json_fields:
            return None
        docs = []
        for fid, raw in sorted(resource.json_fields.items()):
            try:
                value = json.loads(raw)
            except (TypeError, ValueError):
                continue
            docs.append(
                {
                    "key": f"{resource.resource_id}/{fid}",
                    "paths": flatten_json(value),
                }
            )
        if not docs:
            return None
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "docs.msgpack"), "wb") as f:
            f.write(msgpack.packb(docs))
        meta = {"records": len(docs), "kind": "json"}
        with open(os.path.join(output_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return SegmentMetadata(path=output_dir, records=len(docs), index_metadata=meta)

    def deletions_for_resource(self, resource: ResourceDoc) -> list[str]:
        if resource.json_fields_to_delete:
            return [
                f"{resource.resource_id}/{fid}"
                for fid in resource.json_fields_to_delete
            ]
        return [resource.resource_id + "/"]

    def merge(self, open_index: OpenIndexMetadata, output_dir: str) -> SegmentMetadata:
        deletions = list(open_index.deletions())
        out = []
        for seg_meta, seq in open_index.segments():
            applicable = [k for k, dseq in deletions if dseq > seq]
            for d in _load_docs(seg_meta.path):
                if any(key_matches_prefix(d["key"], p) for p in applicable):
                    continue
                out.append(d)
        out.sort(key=lambda d: d["key"])
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "docs.msgpack"), "wb") as f:
            f.write(msgpack.packb(out))
        meta = {"records": len(out), "kind": "json"}
        with open(os.path.join(output_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return SegmentMetadata(path=output_dir, records=len(out), index_metadata=meta)


def _load_docs(path: str) -> list[dict]:
    with open(os.path.join(path, "docs.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read())


# --- query model (parity: JsonFilterExpression) ---------------------------


@dataclass
class JsonPredicate:
    path: str
    op: str  # "eq" | "ne" | "gt" | "gte" | "lt" | "lte" | "exists"
    value: Any = None
    # restrict the predicate to one NucliaDB field (parity: nodereader
    # JsonFieldPathFilter.field_id, e.g. "t/title"); None = any field
    field_id: Optional[str] = None


@dataclass
class JsonAnd:
    operands: list["JsonExpression"]


@dataclass
class JsonOr:
    operands: list["JsonExpression"]


@dataclass
class JsonNot:
    operand: "JsonExpression"


JsonExpression = Union[JsonPredicate, JsonAnd, JsonOr, JsonNot]


def _pred_matches(pred: JsonPredicate, values: list[Any]) -> bool:
    if pred.op == "exists":
        return len(values) > 0
    for v in values:
        if pred.op == "eq" and v == pred.value:
            return True
        if pred.op == "ne" and v != pred.value:
            return True
        # ranges compare numerically, or lexicographically for strings
        # (RFC3339 date strings — nodereader JsonFieldPathFilter date_range)
        comparable = (
            isinstance(v, (int, float)) and isinstance(pred.value, (int, float))
        ) or (isinstance(v, str) and isinstance(pred.value, str))
        if comparable:
            if pred.op == "gt" and v > pred.value:
                return True
            if pred.op == "gte" and v >= pred.value:
                return True
            if pred.op == "lt" and v < pred.value:
                return True
            if pred.op == "lte" and v <= pred.value:
                return True
    return False


class _PathColumns:
    """Typed postings of one flattened path, evaluated vectorized.

    Parity: the reference indexes flattened JSON paths with typed tantivy
    fields and evaluates predicates as index queries (nidx_json/src/search.rs,
    schema.rs); the round-1 per-doc python loop was O(docs) host time per
    filtered query. Here each path holds value-sorted numeric postings
    (range ops = searchsorted), per-string doc postings (eq = dict hit),
    null postings, and the with-duplicates doc list (exists/ne counting).
    """

    __slots__ = (
        "num_vals", "num_docs", "strs", "nulls", "all_docs",
        "str_vals", "str_docs",
    )

    def __init__(self):
        self.num_vals: list[float] = []
        self.num_docs: list[int] = []
        self.strs: dict[str, list[int]] = {}
        self.nulls: list[int] = []
        self.all_docs: list[int] = []

    def freeze(self):
        nv = np.asarray(self.num_vals, np.float64)
        nd = np.asarray(self.num_docs, np.int32)
        order = np.argsort(nv, kind="stable")
        self.num_vals, self.num_docs = nv[order], nd[order]
        self.strs = {s: np.asarray(d, np.int32) for s, d in self.strs.items()}
        # value-sorted string postings for lexicographic ranges (RFC3339
        # date strings — the reference types such paths as tantivy dates)
        pairs = sorted(
            (s, doc) for s, docs in self.strs.items() for doc in docs
        )
        self.str_vals = np.array([p[0] for p in pairs], dtype=np.str_)
        self.str_docs = np.array([p[1] for p in pairs], dtype=np.int32)
        self.nulls = np.asarray(self.nulls, np.int32)
        self.all_docs = np.asarray(self.all_docs, np.int32)
        return self

    # -- predicate evaluation (doc arrays may contain duplicates) ---------

    def eq_docs(self, value: Any) -> np.ndarray:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return self._num_eq(float(value))
        if isinstance(value, bool):
            # python bool compares numerically (True == 1), matching the
            # scalar oracle's `v == pred.value`
            return self._num_eq(float(value))
        if isinstance(value, str):
            return self.strs.get(value, np.zeros(0, np.int32))
        if value is None:
            return self.nulls
        return np.zeros(0, np.int32)

    def _num_eq(self, v: float) -> np.ndarray:
        lo = np.searchsorted(self.num_vals, v, side="left")
        hi = np.searchsorted(self.num_vals, v, side="right")
        return self.num_docs[lo:hi]

    def range_docs(self, op: str, value: Any) -> np.ndarray:
        if isinstance(value, str):
            vals, docs = self.str_vals, self.str_docs
            if not vals.size:
                return np.zeros(0, np.int32)
            v: Any = value
        elif isinstance(value, (int, float)):
            vals, docs = self.num_vals, self.num_docs
            v = float(value)
        else:
            return np.zeros(0, np.int32)
        if op == "gt":
            return docs[np.searchsorted(vals, v, "right"):]
        if op == "gte":
            return docs[np.searchsorted(vals, v, "left"):]
        if op == "lt":
            return docs[: np.searchsorted(vals, v, "left")]
        if op == "lte":
            return docs[: np.searchsorted(vals, v, "right")]
        raise ValueError(op)


class JsonSearcher:
    def __init__(self, open_index: OpenIndexMetadata):
        deletions = list(open_index.deletions())
        self.docs: list[dict] = []
        for seg_meta, seq in open_index.segments():
            applicable = [k for k, dseq in deletions if dseq > seq]
            for d in _load_docs(seg_meta.path):
                if any(key_matches_prefix(d["key"], p) for p in applicable):
                    continue
                self.docs.append(d)
        self.n_docs = len(self.docs)
        self._fields: list[FieldId] = []
        for d in self.docs:
            rid, fid = d["key"].split("/", 1)
            self._fields.append(FieldId(resource_id=rid, field_id=fid))
        self._field_id_arr = np.array(
            [f.field_id for f in self._fields], dtype=np.str_
        ) if self.n_docs else np.zeros(0, dtype="<U1")
        self._field_masks: dict[str, np.ndarray] = {}

        # consolidate typed columns per path
        cols: dict[str, _PathColumns] = {}
        for i, d in enumerate(self.docs):
            for p, v in d["paths"]:
                c = cols.get(p)
                if c is None:
                    c = cols[p] = _PathColumns()
                c.all_docs.append(i)
                if isinstance(v, (bool, int, float)):
                    c.num_vals.append(float(v))
                    c.num_docs.append(i)
                elif isinstance(v, str):
                    c.strs.setdefault(v, []).append(i)
                elif v is None:
                    c.nulls.append(i)
        self.columns = {p: c.freeze() for p, c in cols.items()}
        # per-path total value counts per doc (ne needs "has a value that
        # is not X", i.e. total > matching)
        self._path_counts: dict[str, np.ndarray] = {}

    def _counts(self, path: str, col: _PathColumns) -> np.ndarray:
        counts = self._path_counts.get(path)
        if counts is None:
            counts = np.bincount(col.all_docs, minlength=self.n_docs)
            self._path_counts[path] = counts
        return counts

    def _eval(self, expr: JsonExpression) -> np.ndarray:
        """Boolean [n_docs] mask, fully vectorized."""
        if isinstance(expr, JsonPredicate):
            mask = np.zeros(self.n_docs, dtype=bool)
            col = self.columns.get(expr.path)
            if col is None:
                return mask
            if expr.op == "exists":
                mask[col.all_docs] = True
            elif expr.op == "eq":
                mask[col.eq_docs(expr.value)] = True
            elif expr.op == "ne":
                # any value != pred.value: total per-doc values exceed the
                # per-doc count of values equal to it
                eq = np.bincount(col.eq_docs(expr.value), minlength=self.n_docs)
                mask = self._counts(expr.path, col) > eq
            elif expr.op in ("gt", "gte", "lt", "lte"):
                mask[col.range_docs(expr.op, expr.value)] = True
            else:
                raise ValueError(f"bad json op: {expr.op}")
            if expr.field_id is not None:
                fmask = self._field_masks.get(expr.field_id)
                if fmask is None:
                    fmask = self._field_id_arr == expr.field_id
                    self._field_masks[expr.field_id] = fmask
                mask = mask & fmask
            return mask
        if isinstance(expr, JsonAnd):
            mask = np.ones(self.n_docs, dtype=bool)
            for op in expr.operands:
                mask &= self._eval(op)
            return mask
        if isinstance(expr, JsonOr):
            mask = np.zeros(self.n_docs, dtype=bool)
            for op in expr.operands:
                mask |= self._eval(op)
            return mask
        if isinstance(expr, JsonNot):
            return ~self._eval(expr.operand)
        raise TypeError(f"bad json expression: {expr!r}")

    def _matches(self, expr: JsonExpression, doc_idx: int) -> bool:
        """Scalar reference semantics (kept as the differential oracle)."""
        if isinstance(expr, JsonPredicate):
            if (
                expr.field_id is not None
                and self._fields[doc_idx].field_id != expr.field_id
            ):
                return False
            values = [v for p, v in self.docs[doc_idx]["paths"] if p == expr.path]
            return _pred_matches(expr, values)
        if isinstance(expr, JsonAnd):
            return all(self._matches(op, doc_idx) for op in expr.operands)
        if isinstance(expr, JsonOr):
            return any(self._matches(op, doc_idx) for op in expr.operands)
        if isinstance(expr, JsonNot):
            return not self._matches(expr.operand, doc_idx)
        raise TypeError(f"bad json expression: {expr!r}")

    def prefilter(self, expr: Optional[JsonExpression]) -> PrefilterResult:
        """Evaluate a JSON filter into a RESOURCE-granular prefilter
        (combined with the text prefilter by the planner). Resource
        granularity is the reference's: the json side contributes resource
        uuids (prefilter.rs combine takes a resource set; to_field_ids makes
        field_id-less entries) — a match on any json field of a resource
        admits every field of that resource downstream."""
        if expr is None:
            return PrefilterResult.all()
        mask = self._eval(expr)
        idxs = np.nonzero(mask)[0]
        if not len(idxs):
            return PrefilterResult.none()
        rids = sorted({self._fields[i].resource_id for i in idxs})
        return PrefilterResult.some([FieldId(rid, None) for rid in rids])

"""Relation (graph) index: entity/relation edges with path queries.

The port's copy of ``nucliadb_tpu/index/relation/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity surface with the reference's nidx_relation crate
(nidx_relation/src/lib.rs:124-263, schema.rs:65-94, graph_query_parser.rs):
one document per edge — source/target node (value, type, subtype), relation
type + label, metadata, facets, originating resource field — queried with
single-hop graph path patterns (source/relation/target constraints, fuzzy
node matching with distance 1, undirected option), entity-prefix suggest,
and top-unique-N node collection.

Evaluation is columnar: edges are interned into unique-node and
unique-(relation,label) tables at open time, patterns are evaluated ONCE
per unique value (so fuzzy/semantic matching scales with vocabulary size,
not edge count — the same role tantivy's term dictionary plays in the
reference), and boolean expressions compose as NaN-masked numpy score
arrays over the edge columns. The scalar per-edge evaluator is kept as the
differential oracle (see ``_compile_expr``), mirroring how the reference's
semantics are a per-document tantivy BooleanQuery.

The semantic graph search (node/edge *vectors*) runs through the vector
index like the reference's field_node_vectors/field_edge_vectors do.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field
from typing import Callable, Optional, Sequence

import msgpack
import numpy as np

from ...models.internal import IndexRelation, ResourceDoc
from ...types import OpenIndexMetadata, SegmentMetadata, Seq
from ...utils.keys import key_matches_prefix
from ..text_engine.fuzzy import FuzzyIndex, osa_leq
from ..text_engine.tokenizer import strip_diacritics, tokenize

FUZZY_DISTANCE = 1  # parity: nidx_relation/src/reader.rs:33


def _edge_dict(rel: IndexRelation, key: str) -> dict:
    return {
        "key": key,
        "source_value": rel.source.value,
        "source_type": rel.source.ntype,
        "source_subtype": rel.source.subtype,
        "target_value": rel.target.value,
        "target_type": rel.target.ntype,
        "target_subtype": rel.target.subtype,
        "relation": rel.relation,
        "label": rel.label,
        "metadata": rel.metadata,
        "facets": rel.facets,
    }


def _vector_entries(per_field: dict, value_key: str, rid: str) -> list[dict]:
    """Flatten field_{node,edge}_vectors into deletion-keyed rows."""
    out: list[dict] = []
    for fid, per_vs in per_field.items():
        key = f"{rid}/{fid}"
        for vs, vecs in per_vs.items():
            for value, vec in vecs.items():
                out.append({
                    "key": key,
                    "vs": vs,
                    value_key: value,
                    "vector": [float(x) for x in np.asarray(vec, np.float32)],
                })
    out.sort(key=lambda r: r["key"])
    return out


def _write_vectors(output_dir: str, name: str, rows: list[dict]) -> None:
    if rows:
        with open(os.path.join(output_dir, name), "wb") as f:
            f.write(msgpack.packb(rows))


def _load_vectors(path: str, name: str) -> list[dict]:
    p = os.path.join(path, name)
    if not os.path.exists(p):
        return []
    with open(p, "rb") as f:
        return msgpack.unpackb(f.read())


class RelationIndexer:
    def index_resource(
        self, resource: ResourceDoc, output_dir: str
    ) -> Optional[SegmentMetadata]:
        edges: list[dict] = []
        for fid, relations in resource.relations.items():
            key = f"{resource.resource_id}/{fid}"
            for rel in relations:
                edges.append(_edge_dict(rel, key))
        # graph semantic embeddings ride the same segment, keyed {rid}/{fid}
        # so relation_fields_to_delete prefixes apply to them too (parity:
        # nidx_vector/src/indexer.rs index_relation_nodes/edges builds
        # separate vector segments; here the relation segment is columnar
        # host data and the vectors are just two more columns)
        nvecs = _vector_entries(
            resource.field_node_vectors, "value", resource.resource_id
        )
        evecs = _vector_entries(
            resource.field_edge_vectors, "label", resource.resource_id
        )
        if not edges and not nvecs and not evecs:
            return None
        edges.sort(key=lambda e: e["key"])
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "edges.msgpack"), "wb") as f:
            f.write(msgpack.packb(edges))
        _write_vectors(output_dir, "node_vectors.msgpack", nvecs)
        _write_vectors(output_dir, "edge_vectors.msgpack", evecs)
        records = len(edges) + len(nvecs) + len(evecs)
        meta = {"records": records, "kind": "relation"}
        with open(os.path.join(output_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return SegmentMetadata(path=output_dir, records=records, index_metadata=meta)

    def deletions_for_resource(self, resource: ResourceDoc) -> list[str]:
        if resource.relation_fields_to_delete:
            return [
                f"{resource.resource_id}/{fid}"
                for fid in resource.relation_fields_to_delete
            ]
        return [resource.resource_id + "/"]

    def merge(self, open_index: OpenIndexMetadata, output_dir: str) -> SegmentMetadata:
        deletions = list(open_index.deletions())
        out: list[dict] = []
        out_nv: list[dict] = []
        out_ev: list[dict] = []
        for seg_meta, seq in open_index.segments():
            applicable = [k for k, dseq in deletions if dseq > seq]

            def alive(key: str) -> bool:
                return not any(key_matches_prefix(key, p) for p in applicable)

            out.extend(e for e in _load_edges(seg_meta.path) if alive(e["key"]))
            out_nv.extend(
                r for r in _load_vectors(seg_meta.path, "node_vectors.msgpack")
                if alive(r["key"])
            )
            out_ev.extend(
                r for r in _load_vectors(seg_meta.path, "edge_vectors.msgpack")
                if alive(r["key"])
            )
        out.sort(key=lambda e: e["key"])
        out_nv.sort(key=lambda r: r["key"])
        out_ev.sort(key=lambda r: r["key"])
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "edges.msgpack"), "wb") as f:
            f.write(msgpack.packb(out))
        _write_vectors(output_dir, "node_vectors.msgpack", out_nv)
        _write_vectors(output_dir, "edge_vectors.msgpack", out_ev)
        records = len(out) + len(out_nv) + len(out_ev)
        meta = {"records": records, "kind": "relation"}
        with open(os.path.join(output_dir, "meta.json"), "w") as f:
            json.dump(meta, f)
        return SegmentMetadata(path=output_dir, records=records, index_metadata=meta)


def _load_edges(path: str) -> list[dict]:
    with open(os.path.join(path, "edges.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read())


@dataclass
class NodePattern:
    """Constraint on one end of a path (parity: GraphQuery node,
    graph_query_parser.rs Term variants).

    ``match`` selects the value semantics (NodeMatchKindName):
      exact        normalized full-value equality (prefix option)
      fuzzy        OSA distance ≤1 on the normalized full value
                   (tantivy FuzzyTermQuery with transpositions)
      fuzzy_words  every query word fuzzy-matches (d≤1) some word of the
                   node value (Term::FuzzyWord — intersection of per-word
                   fuzzy queries over the tokenized field)
      semantic     value resolved upstream to ``semantic_matches``
                   (Term::FromVectorQuery — const-score union of the
                   vector-nearest node values)
    """

    value: Optional[str] = None
    ntype: Optional[str] = None
    subtype: Optional[str] = None
    fuzzy: bool = False  # legacy flag; same as match="fuzzy"
    prefix: bool = False
    match: str = "exact"
    # edit-distance budget for fuzzy/fuzzy_words (proto FuzzyMatch.distance;
    # 0 = exact words / exact prefix, the Exact{WORDS,PREFIX_WORDS} kinds)
    distance: int = FUZZY_DISTANCE
    semantic_matches: Optional[dict[str, float]] = None  # normalized -> score


@dataclass
class RelationPattern:
    relation: Optional[str] = None  # relation type
    label: Optional[str] = None
    match: str = "exact"  # exact | semantic (RelationMatchKindName)
    semantic_matches: Optional[dict[str, float]] = None  # normalized -> score


@dataclass
class GraphSearchRequest:
    """Single-hop path query (parity: nodereader GraphSearchRequest)."""

    source: NodePattern = dc_field(default_factory=NodePattern)
    relation: RelationPattern = dc_field(default_factory=RelationPattern)
    target: NodePattern = dc_field(default_factory=NodePattern)
    undirected: bool = False
    top_k: int = 50


@dataclass
class GraphNode:
    value: str
    ntype: str
    subtype: str


@dataclass
class GraphPath:
    source: GraphNode
    relation: str
    label: str
    target: GraphNode
    metadata: dict
    resource_field: str
    score: float = 1.0
    facets: list[str] = dc_field(default_factory=list)


def prefilter_edge_ok(prefilter) -> "Callable[[dict], bool] | None":
    """Edge predicate from a FieldId prefilter, or None when unrestricted.

    Parity: nidx_relation/src/reader.rs:261-271 apply_prefilter +
    AddMetadataFieldIterator (:68-97) — the ``a/metadata`` field of every
    listed resource is ALWAYS admitted (user relations index there even
    though the prefiltering text index has no such field)."""
    if prefilter.is_all:
        return None
    allowed: set[str] = set()
    prefixes: list[str] = []
    for f in prefilter.fields:
        if f.field_id is None:
            # resource-granular entry: every field of the resource
            prefixes.append(f"{f.resource_id}/")
            continue
        allowed.add(f"{f.resource_id}/{f.field_id}")
        allowed.add(f"{f.resource_id}/a/metadata")
    return lambda e: e["key"] in allowed or any(
        e["key"].startswith(p) for p in prefixes
    )


def _str_array(values: list[str]) -> np.ndarray:
    if not values:
        return np.zeros(0, dtype="<U1")
    return np.array(values, dtype=np.str_)


class RelationSearcher:
    def __init__(self, open_index: OpenIndexMetadata):
        deletions = list(open_index.deletions())
        self.edges: list[dict] = []
        self._node_vec_rows: list[dict] = []
        self._edge_vec_rows: list[dict] = []
        for seg_meta, seq in open_index.segments():
            edges = _load_edges(seg_meta.path)
            applicable = [k for k, dseq in deletions if dseq > seq]

            def alive(key: str) -> bool:
                return not any(key_matches_prefix(key, p) for p in applicable)

            for e in edges:
                if alive(e["key"]):
                    self.edges.append(e)
            self._node_vec_rows.extend(
                r for r in _load_vectors(seg_meta.path, "node_vectors.msgpack")
                if alive(r["key"])
            )
            self._edge_vec_rows.extend(
                r for r in _load_vectors(seg_meta.path, "edge_vectors.msgpack")
                if alive(r["key"])
            )
        self._vec_tables: dict[tuple[str, str], tuple[list[str], np.ndarray]] | None = None
        values = sorted(
            {e["source_value"] for e in self.edges}
            | {e["target_value"] for e in self.edges}
        )
        # sort by NORMALIZED value: prefix suggest bisects _norm_values, so
        # the normalized list must be the sorted one (case-sensitive ordering
        # of the originals is not, e.g. ['Zebra', 'apple'])
        pairs = sorted((strip_diacritics(v.lower()), v) for v in values)
        self.node_values = [v for _, v in pairs]
        self._norm_values = [n for n, _ in pairs]
        self._fuzzy: FuzzyIndex | None = None
        self._build_columns()

    # ---- columnar build -------------------------------------------------

    def _build_columns(self) -> None:
        """Intern edges into unique node / relation tables + edge columns.

        The node table is keyed by the full (value, type, subtype) triple —
        pattern evaluation happens once per unique triple, edge evaluation
        is then pure integer indexing (the tantivy term-dictionary role,
        nidx_relation/src/schema.rs:65-94 fields)."""
        E = len(self.edges)
        node_ids: dict[tuple[str, str, str], int] = {}
        node_rows: list[tuple[str, str, str]] = []
        rel_ids: dict[tuple[str, str], int] = {}
        rel_rows: list[tuple[str, str]] = []
        src = np.zeros(E, np.int32)
        dst = np.zeros(E, np.int32)
        rel = np.zeros(E, np.int32)
        keys: list[str] = []
        facet_strs: list[str] = []
        facet_edge: list[int] = []
        for i, e in enumerate(self.edges):
            skey = (e["source_value"], e["source_type"], e["source_subtype"])
            tkey = (e["target_value"], e["target_type"], e["target_subtype"])
            rkey = (e["relation"], e["label"])
            for key, arr in ((skey, src), (tkey, dst)):
                nid = node_ids.get(key)
                if nid is None:
                    nid = node_ids[key] = len(node_rows)
                    node_rows.append(key)
                arr[i] = nid
            rid = rel_ids.get(rkey)
            if rid is None:
                rid = rel_ids[rkey] = len(rel_rows)
                rel_rows.append(rkey)
            rel[i] = rid
            keys.append(e["key"])
            for fct in e.get("facets") or []:
                facet_strs.append(fct)
                facet_edge.append(i)
        self._src_id, self._dst_id, self._rel_id = src, dst, rel
        self._n_values = [r[0] for r in node_rows]
        self._n_norm_list = [strip_diacritics(r[0].lower()) for r in node_rows]
        self._n_norm = _str_array(self._n_norm_list)
        self._n_types = _str_array([r[1] for r in node_rows])
        self._n_subtypes = _str_array([r[2] for r in node_rows])
        self._node_rows = node_rows
        self._r_types = _str_array([r[0] for r in rel_rows])
        self._r_labels = _str_array([r[1] for r in rel_rows])
        self._r_norm_labels = [strip_diacritics(r[1].lower()) for r in rel_rows]
        self._rel_rows = rel_rows
        # stable rank by key for the score tie-break (reference orders ties
        # by document, which follows the key-sorted segment layout)
        order = np.argsort(np.array(keys, dtype=np.str_), kind="stable") if keys else np.zeros(0, np.int64)
        self._key_rank = np.zeros(E, np.int64)
        self._key_rank[order] = np.arange(E)
        self._facet_strs = _str_array(facet_strs)
        self._facet_edge = np.array(facet_edge, np.int64) if facet_edge else np.zeros(0, np.int64)
        self._node_words: list[list[str]] | None = None  # lazy (fuzzy_words)
        # term-dictionary accelerators (lazy — the tantivy/FST role,
        # nidx_relation/src/lib.rs:124-263 serving selective terms from
        # dictionaries instead of scanning): norm value -> node-triple ids,
        # sorted norm values for prefix ranges, and low-cardinality
        # type/subtype masks. Each replaces an O(U) string scan per query
        # with an O(log U) or O(1) lookup + sparse mask fill.
        self._value_post: dict[str, np.ndarray] | None = None
        self._norm_sorted: np.ndarray | None = None
        self._norm_order: np.ndarray | None = None
        self._filter_masks: dict[tuple[str, str], np.ndarray] = {}
        # node id -> incident edge ids (CSR over the src / dst columns):
        # the sparse fast path for selective path queries evaluates only
        # the candidate edges instead of dense [E] passes
        self._src_csr: tuple[np.ndarray, np.ndarray] | None = None
        self._dst_csr: tuple[np.ndarray, np.ndarray] | None = None
        # value -> (type, subtype): source occurrences take priority over
        # target ones (matches the original first-source-then-target scan)
        self._value_ts: dict[str, tuple[str, str]] = {}
        for e in self.edges:
            self._value_ts.setdefault(
                e["source_value"], (e["source_type"], e["source_subtype"])
            )
        for e in self.edges:
            self._value_ts.setdefault(
                e["target_value"], (e["target_type"], e["target_subtype"])
            )

    @property
    def fuzzy_index(self) -> FuzzyIndex:
        if self._fuzzy is None:
            self._fuzzy = FuzzyIndex(self._norm_values)
        return self._fuzzy

    # ---- graph semantic vectors (VectorMatch at the node plane) ----------
    # Parity: the reference stores relation node/edge embeddings in
    # dedicated vector indexes (nidx_vector/src/indexer.rs
    # index_relation_nodes/edges) and resolves GraphQuery VectorMatch
    # leaves through them before the tantivy evaluation
    # (shard_search.rs run_semantic_graph_queries -> FromVectorQuery).
    # Here the embeddings are columns of the relation segment; a match is
    # one [M, D] x [D] matmul over the (small, host-resident) node-value
    # table — far below the device-dispatch threshold (the same cost-model
    # posture as the vector index's EXACT_SCAN_THRESHOLD).

    # over-request so duplicate values don't crowd out unique ones
    # (parity: query_planner.rs GRAPH_VECTOR_OVERREQUEST_FACTOR/MIN/MAX)
    VECTOR_OVERREQUEST_FACTOR = 10
    VECTOR_REQUEST_MIN = 50
    VECTOR_REQUEST_MAX = 200

    def _vec_table(self, kind: str, vectorset: str):
        if self._vec_tables is None:
            tables: dict[tuple[str, str], tuple[list[str], np.ndarray]] = {}
            for kind_, rows, value_key in (
                ("node", self._node_vec_rows, "value"),
                ("edge", self._edge_vec_rows, "label"),
            ):
                by_vs: dict[str, list[dict]] = {}
                for r in rows:
                    by_vs.setdefault(r["vs"], []).append(r)
                for vs, group in by_vs.items():
                    values = [
                        strip_diacritics(str(r[value_key]).lower()) for r in group
                    ]
                    mat = np.asarray([r["vector"] for r in group], np.float32)
                    tables[(kind_, vs)] = (values, mat)
            self._vec_tables = tables
        return self._vec_tables.get((kind, vectorset))

    def _semantic_matches(
        self, kind: str, vectorset: str, qvec, top_n: int, min_score: float
    ) -> dict[str, float]:
        table = self._vec_table(kind, vectorset)
        if table is None:
            raise LookupError(
                f"no graph {kind} vectors indexed for vectorset {vectorset!r}"
            )
        values, mat = table
        q = np.asarray(qvec, np.float32).reshape(-1)
        if mat.shape[1] != q.shape[0]:
            raise ValueError(
                f"graph {kind} vector dimension {q.shape[0]} != indexed {mat.shape[1]}"
            )
        scores = mat @ q
        best: dict[str, float] = {}
        for i in np.argsort(-scores):
            s = float(scores[i])
            if s < min_score:
                break
            v = values[int(i)]
            if v not in best:
                best[v] = s
                if len(best) >= top_n:
                    break
        return best

    def semantic_node_matches(
        self, vectorset: str, qvec, top_n: int, min_score: float = 0.0
    ) -> dict[str, float]:
        """Vector-nearest node values (normalized) -> score."""
        return self._semantic_matches("node", vectorset, qvec, top_n, min_score)

    def semantic_edge_matches(
        self, vectorset: str, qvec, top_n: int, min_score: float = 0.0
    ) -> dict[str, float]:
        """Vector-nearest relation labels (normalized) -> score."""
        return self._semantic_matches("edge", vectorset, qvec, top_n, min_score)

    def resolve_vector_leaves(
        self,
        query: dict,
        *,
        top_k: int,
        node_vectorset: Optional[str] = None,
        edge_vectorset: Optional[str] = None,
        node_min_score: float = 0.0,
        edge_min_score: float = 0.0,
    ) -> dict:
        """Replace raw ``vector`` leaves in a native graph expr with
        ``semantic_matches`` resolved against the indexed node/edge vector
        tables. Raises LookupError when a leaf needs a vectorset that is
        not given or not indexed (parity: shard_search.rs:363-380 answers
        NidxError::NotFound)."""
        top_n = max(
            self.VECTOR_REQUEST_MIN,
            min(top_k * self.VECTOR_OVERREQUEST_FACTOR, self.VECTOR_REQUEST_MAX),
        )

        def resolve_leaf(d: dict, kind: str) -> dict:
            if not isinstance(d, dict) or "vector" not in d:
                return d
            vs = node_vectorset if kind == "node" else edge_vectorset
            if not vs:
                raise LookupError(
                    f"graph query has a {kind} vector match but no "
                    f"graph_{kind}_vectorset was given"
                )
            min_s = node_min_score if kind == "node" else edge_min_score
            fn = (
                self.semantic_node_matches
                if kind == "node"
                else self.semantic_edge_matches
            )
            out = {k: v for k, v in d.items() if k != "vector"}
            out["match"] = "semantic"
            out["semantic_matches"] = fn(vs, d["vector"], top_n, min_s)
            return out

        def walk(q):
            if not isinstance(q, dict):
                return q
            if "and" in q:
                return {**q, "and": [walk(x) for x in q["and"]]}
            if "or" in q:
                return {**q, "or": [walk(x) for x in q["or"]]}
            if "not" in q:
                return {**q, "not": walk(q["not"])}
            prop = q.get("prop")
            if prop == "path":
                out = dict(q)
                if q.get("source"):
                    out["source"] = resolve_leaf(q["source"], "node")
                if q.get("destination"):
                    out["destination"] = resolve_leaf(q["destination"], "node")
                if q.get("relation"):
                    out["relation"] = resolve_leaf(q["relation"], "edge")
                return out
            if prop in ("node", "source_node", "destination_node"):
                return resolve_leaf(q, "node")
            if prop == "relation":
                return resolve_leaf(q, "edge")
            return q

        return walk(query)

    # ---- vectorized pattern evaluation ----------------------------------
    # Score arrays use NaN for "no match"; matched clause scores sum
    # (tantivy's BooleanQuery sums matching Must/Should clause scores);
    # semantic matches contribute the vector score (ConstScoreQuery,
    # graph_query_parser.rs:497-505).

    def _value_postings(self) -> dict[str, np.ndarray]:
        """norm value -> node-triple ids (built once per searcher)."""
        vp = self._value_post
        if vp is None:
            lists: dict[str, list[int]] = {}
            for i, nv in enumerate(self._n_norm_list):
                lists.setdefault(nv, []).append(i)
            vp = self._value_post = {
                k: np.asarray(v, np.int64) for k, v in lists.items()
            }
        return vp

    def _norm_range_ids(self, lo_q: str, hi_q: str) -> np.ndarray:
        """Node-triple ids whose norm value falls in [lo_q, hi_q)."""
        if self._norm_sorted is None:
            self._norm_order = np.argsort(self._n_norm, kind="stable")
            self._norm_sorted = self._n_norm[self._norm_order]
        lo = int(np.searchsorted(self._norm_sorted, lo_q, side="left"))
        hi = int(np.searchsorted(self._norm_sorted, hi_q, side="left"))
        return self._norm_order[lo:hi]

    def _filter_mask(self, kind: str, value: str) -> np.ndarray:
        """Cached [U] bool mask for a type/subtype equality filter —
        filter vocabularies are tiny, so each distinct value scans once."""
        key = (kind, value)
        mask = self._filter_masks.get(key)
        if mask is None:
            col = self._n_types if kind == "type" else self._n_subtypes
            mask = self._filter_masks[key] = col == value
        return mask

    @staticmethod
    def _ids_mask(ids: np.ndarray, u: int) -> np.ndarray:
        ok = np.zeros(u, bool)
        if len(ids):
            ok[ids] = True
        return ok

    def _node_pattern_scores(self, pattern: NodePattern) -> np.ndarray:
        """Score every unique node triple against a pattern → [U] float32,
        NaN = no match."""
        U = len(self._node_rows)
        score = np.zeros(U, np.float32)
        if pattern.ntype is not None:
            ok = self._filter_mask("type", pattern.ntype)
            score = np.where(ok, score + 1.0, np.nan)
        if pattern.subtype is not None and pattern.subtype != "":
            ok = self._filter_mask("subtype", pattern.subtype)
            score = np.where(ok, score + 1.0, np.nan)
        if pattern.match == "semantic":
            # semantic leaves carry resolved matches, not a value (a raw
            # VectorMatch has no value at all) — look up every node norm
            sem = pattern.semantic_matches or {}
            add = np.array(
                [sem.get(n, np.nan) for n in self._n_norm_list], np.float32
            ) if U else np.zeros(0, np.float32)
            return score + add
        if pattern.value is None:
            return score
        match = pattern.match
        if pattern.fuzzy and match == "exact":
            match = "fuzzy"
        norm_q = strip_diacritics(pattern.value.lower())
        if match == "fuzzy_words":
            # Term::FuzzyWord — every query word must fuzzy-match (OSA d≤1,
            # transpositions) some word of the tokenized node value
            if self._node_words is None:
                self._node_words = [tokenize(n) for n in self._n_norm_list]
            q_words = tokenize(norm_q)
            add = np.full(U, np.nan, np.float32)
            if q_words:
                for i in np.flatnonzero(~np.isnan(score)):
                    node_words = self._node_words[i]
                    if not node_words:
                        continue
                    hit = True
                    for j, qw in enumerate(q_words):
                        last = pattern.prefix and j == len(q_words) - 1
                        if not any(
                            self._word_matches(
                                qw, nw, prefix=last, distance=pattern.distance
                            )
                            for nw in node_words
                        ):
                            hit = False
                            break
                    if hit:
                        add[i] = 1.0
            return score + add
        if match == "fuzzy":
            d = pattern.distance
            from ..text_engine.fuzzy import MIN_FUZZY_LEN

            if (
                not pattern.prefix
                and d <= 1
                and len(norm_q) >= MIN_FUZZY_LEN
                and U
            ):
                # dictionary fast path: symmetric-delete expansion over the
                # unique-value vocabulary (the FST role) instead of an
                # O(U) OSA loop — same osa_leq verification inside expand
                vp = self._value_postings()
                ids = [
                    vp[v]
                    for v in self.fuzzy_index.expand(norm_q, d)
                    if v in vp
                ]
                hit = self._ids_mask(
                    np.concatenate(ids) if ids else np.zeros(0, np.int64), U
                )
                add = np.where(hit, np.float32(1.0), np.nan)
                return score + add
            add = np.full(U, np.nan, np.float32)
            for i in np.flatnonzero(~np.isnan(score)):
                norm_v = self._n_norm_list[i]
                if pattern.prefix:
                    # FuzzyTermQuery::new_prefix — the query matches within
                    # the value's leading len(q)±d window
                    lq = len(norm_q)
                    for cut in range(max(lq - d, 0), lq + d + 1):
                        if osa_leq(norm_q, norm_v[:cut], d):
                            add[i] = 1.0
                            break
                elif osa_leq(norm_q, norm_v, d):
                    add[i] = 1.0
            return score + add
        # exact — served from the value dictionary / sorted range instead of
        # an O(U) string-column scan
        if pattern.prefix:
            if U:
                ids = self._norm_range_ids(norm_q, norm_q + "\U0010ffff")
                ok = self._ids_mask(ids, U)
            else:
                ok = np.zeros(0, bool)
        else:
            ids = self._value_postings().get(norm_q)
            ok = self._ids_mask(
                ids if ids is not None else np.zeros(0, np.int64), U
            )
        return np.where(ok, score + 1.0, np.nan)

    def _rel_pattern_scores(self, pattern: RelationPattern) -> np.ndarray:
        """Score every unique (relation, label) pair → [R] float32, NaN = no
        match. ``match="semantic"`` resolves the label through the upstream
        vector results (RelationTerm::FromVectorQuery)."""
        R = len(self._rel_rows)
        score = np.zeros(R, np.float32)
        if pattern.relation is not None:
            ok = self._r_types == pattern.relation
            score = np.where(ok, score + 1.0, np.nan)
        if pattern.match == "semantic":
            # semantic leaves carry resolved matches, not a label (a raw
            # VectorMatch has no label at all)
            sem = pattern.semantic_matches or {}
            add = np.array(
                [sem.get(n, np.nan) for n in self._r_norm_labels], np.float32
            ) if R else np.zeros(0, np.float32)
            score = score + add
        elif pattern.label is not None:
            ok = self._r_labels == pattern.label
            score = np.where(ok, score + 1.0, np.nan)
        return score

    @staticmethod
    def _or_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Sum where both match, the matching one where one does, NaN where
        neither (tantivy Should-clause union)."""
        both = ~np.isnan(a) & ~np.isnan(b)
        return np.where(both, a + b, np.fmax(a, b))

    def _path_candidates(
        self, src_pat: NodePattern, dst_pat: NodePattern, undirected: bool
    ) -> "np.ndarray | None":
        """Sorted unique candidate edge ids for a path pattern when either
        side resolves through the term dictionaries to few nodes; None =
        no selective side (evaluate dense)."""
        cand = None
        for pat, sides in (
            (src_pat, ("src", "dst") if undirected else ("src",)),
            (dst_pat, ("src", "dst") if undirected else ("dst",)),
        ):
            ids = self._pattern_candidate_node_ids(pat)
            if ids is None or len(ids) > self._SPARSE_NODE_MAX:
                continue
            edges = np.concatenate(
                [self._incident_edges(ids, s) for s in sides]
            ) if len(ids) else np.zeros(0, np.int64)
            if cand is None or len(edges) < len(cand):
                cand = edges
        return np.unique(cand) if cand is not None else None

    def _path_scores(
        self,
        src_pat: NodePattern,
        rel_pat: RelationPattern,
        dst_pat: NodePattern,
        undirected: bool,
    ) -> np.ndarray:
        """Edge-level scores for a single-hop path pattern → [E].

        Sparse when a side is dictionary-selective: scores compute only on
        the CSR-incident candidate edges and scatter into a NaN-filled
        array — one [E] fill instead of ~6 dense [E] passes."""
        cand = self._path_candidates(src_pat, dst_pat, undirected)
        if cand is not None and len(cand) <= len(self.edges) // 4:
            out = np.full(len(self.edges), np.nan, np.float32)
            if len(cand) == 0:
                return out
            rel_s = self._rel_pattern_scores(rel_pat)[self._rel_id[cand]]
            s_src = self._node_pattern_scores(src_pat)
            s_dst = self._node_pattern_scores(dst_pat)
            fwd = rel_s + s_src[self._src_id[cand]] + s_dst[self._dst_id[cand]]
            if undirected:
                bwd = (
                    rel_s
                    + s_src[self._dst_id[cand]]
                    + s_dst[self._src_id[cand]]
                )
                fwd = np.fmax(fwd, bwd)
            out[cand] = fwd
            return out
        rel_s = self._rel_pattern_scores(rel_pat)[self._rel_id]
        s_src = self._node_pattern_scores(src_pat)
        s_dst = self._node_pattern_scores(dst_pat)
        fwd = rel_s + s_src[self._src_id] + s_dst[self._dst_id]
        if not undirected:
            return fwd
        bwd = rel_s + s_src[self._dst_id] + s_dst[self._src_id]
        # max of the matching directions (other direction NaN → fmax keeps
        # the matching one)
        return np.fmax(fwd, bwd)

    def _facet_edge_mask(self, hit: np.ndarray) -> np.ndarray:
        mask = np.zeros(len(self.edges), bool)
        if hit.size:
            mask[self._facet_edge[hit]] = True
        return mask

    def _generated_scores(self, q: dict) -> np.ndarray:
        """``generated`` leaf (requests.py Generated → /g facets,
        query_parser/parsers/graph.py:319-331): user → /g/u facet;
        processor → NOT any /g facet; data-augmentation → /g/da[/task].
        The facet-string scan + edge mask is cached per (by, task) — the
        facet columns are immutable for this searcher's lifetime."""
        by = q.get("by")
        key = ("gen", by, q.get("da_task") or "")
        cached = self._filter_masks.get(key)
        if cached is not None:
            return cached
        strs = self._facet_strs
        if by == "user":
            mask = self._facet_edge_mask(np.flatnonzero(strs == "/g/u"))
            out = np.where(mask, np.float32(0.0), np.nan).astype(np.float32)
        elif by == "processor":
            hit = (strs == "/g") | np.char.startswith(strs, "/g/") if strs.size else np.zeros(0, bool)
            mask = self._facet_edge_mask(np.flatnonzero(hit))
            out = np.where(mask, np.nan, np.float32(0.0)).astype(np.float32)
        elif by == "data-augmentation":
            prefix = "/g/da"
            if q.get("da_task"):
                prefix = f"/g/da/{q['da_task']}"
            hit = np.char.startswith(strs, prefix) if strs.size else np.zeros(0, bool)
            mask = self._facet_edge_mask(np.flatnonzero(hit))
            out = np.where(mask, np.float32(0.0), np.nan).astype(np.float32)
        else:
            raise ValueError(f"unsupported generated.by: {by!r}")
        out.setflags(write=False)  # shared across queries
        self._filter_masks[key] = out
        return out

    def _leaf_node_pattern(self, d: dict) -> NodePattern:
        return NodePattern(
            value=d.get("value"),
            ntype=d.get("type"),
            subtype=d.get("group"),
            match=d.get("match", "exact"),
            prefix=bool(d.get("prefix", False)),
            distance=int(d.get("distance", FUZZY_DISTANCE)),
            semantic_matches=d.get("semantic_matches"),
        )

    def _eval_expr(self, q: dict) -> np.ndarray:
        """Evaluate a boolean path-query tree over the edge columns →
        [E] float32 NaN-masked scores (the tantivy BooleanQuery analogue,
        graph_query_parser.rs:153-237)."""
        if not isinstance(q, dict):
            raise ValueError(f"graph query node must be an object, got {q!r}")
        if "and" in q:
            parts = [self._eval_expr(x) for x in q["and"]]
            total = parts[0]
            for p in parts[1:]:
                total = total + p  # NaN propagates = any-miss kills the AND
            return total
        if "or" in q:
            parts = [self._eval_expr(x) for x in q["or"]]
            stack = np.stack(parts)
            valid = ~np.isnan(stack)
            any_valid = valid.any(axis=0)
            with np.errstate(invalid="ignore"):
                summed = np.nansum(stack, axis=0)
            return np.where(any_valid, summed, np.nan).astype(np.float32)
        if "not" in q:
            s = self._eval_expr(q["not"])
            return np.where(np.isnan(s), np.float32(0.0), np.nan).astype(np.float32)
        prop = q.get("prop")
        if prop == "path":
            src = self._leaf_node_pattern(q.get("source") or {})
            dst = self._leaf_node_pattern(q.get("destination") or {})
            rel_d = q.get("relation") or {}
            rel = RelationPattern(
                label=rel_d.get("label"),
                relation=rel_d.get("type"),
                match=rel_d.get("match", "exact"),
                semantic_matches=rel_d.get("semantic_matches"),
            )
            return self._path_scores(src, rel, dst, bool(q.get("undirected", False)))
        if prop in ("source_node", "destination_node", "node"):
            sc = self._node_pattern_scores(self._leaf_node_pattern(q))
            at_src = sc[self._src_id]
            at_dst = sc[self._dst_id]
            if prop == "source_node":
                return at_src
            if prop == "destination_node":
                return at_dst
            return self._or_scores(at_src, at_dst)
        if prop == "relation":
            rel = RelationPattern(
                label=q.get("label"),
                relation=q.get("type"),
                match=q.get("match", "exact"),
                semantic_matches=q.get("semantic_matches"),
            )
            return self._rel_pattern_scores(rel)[self._rel_id]
        if prop == "generated":
            return self._generated_scores(q)
        if prop == "facet":
            # GraphQuery.PathQuery facet leaf (nodereader.proto:215-217):
            # edges carrying the facet or any descendant path (tantivy
            # facet-term semantics)
            return self._facet_leaf_scores(q.get("facet", ""))
        raise ValueError(f"unsupported graph query node: {q!r}")

    def _facet_leaf_scores(self, facet: str) -> np.ndarray:
        prefix = facet.rstrip("/")
        strs = self._facet_strs
        hit = (
            (strs == prefix) | np.char.startswith(strs, prefix + "/")
            if strs.size
            else np.zeros(0, bool)
        )
        mask = self._facet_edge_mask(np.flatnonzero(hit))
        return np.where(mask, np.float32(0.0), np.nan).astype(np.float32)

    def _eval_node_expr(self, q: dict, position: str) -> np.ndarray:
        """Node-position-scoped evaluation (parity: BoolNodeQuery evaluated
        per NodePosition, graph_query_parser.rs:194-234) → [E] scores of the
        node at ``position`` on each edge."""
        if not isinstance(q, dict):
            raise ValueError(f"graph query node must be an object, got {q!r}")
        if "and" in q:
            parts = [self._eval_node_expr(x, position) for x in q["and"]]
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total
        if "or" in q:
            parts = [self._eval_node_expr(x, position) for x in q["or"]]
            stack = np.stack(parts)
            valid = ~np.isnan(stack)
            any_valid = valid.any(axis=0)
            with np.errstate(invalid="ignore"):
                summed = np.nansum(stack, axis=0)
            return np.where(any_valid, summed, np.nan).astype(np.float32)
        if "not" in q:
            s = self._eval_node_expr(q["not"], position)
            return np.where(np.isnan(s), np.float32(0.0), np.nan).astype(np.float32)
        prop = q.get("prop")
        if prop == "node":
            sc = self._node_pattern_scores(self._leaf_node_pattern(q))
            ids = self._src_id if position == "source" else self._dst_id
            return sc[ids]
        if prop == "generated":
            return self._generated_scores(q)
        raise ValueError(f"unsupported graph nodes query leaf: {q!r}")

    # ---- scalar oracle --------------------------------------------------
    # Per-edge reference semantics, kept as the differential oracle for the
    # vectorized path (tests/test_relation_vectorized.py) — the same split
    # the JSON index uses (index/json/__init__.py _matches).

    def _node_score(
        self, pattern: NodePattern, value: str, ntype: str, subtype: str
    ) -> Optional[float]:
        """Score a node against a pattern; None = no match (scalar oracle)."""
        score = 0.0
        if pattern.ntype is not None:
            if ntype != pattern.ntype:
                return None
            score += 1.0
        if pattern.subtype is not None and pattern.subtype != "":
            if subtype != pattern.subtype:
                return None
            score += 1.0
        if pattern.match == "semantic":
            # semantic leaves may carry no value (raw VectorMatch)
            sem = pattern.semantic_matches or {}
            s = sem.get(strip_diacritics(value.lower()))
            if s is None:
                return None
            return score + float(s)
        if pattern.value is None:
            return score
        norm_v = strip_diacritics(value.lower())
        match = pattern.match
        if pattern.fuzzy and match == "exact":
            match = "fuzzy"
        norm_q = strip_diacritics(pattern.value.lower())
        if match == "fuzzy_words":
            node_words = tokenize(norm_v)
            q_words = tokenize(norm_q)
            if not q_words or not node_words:
                return None
            for i, qw in enumerate(q_words):
                last = pattern.prefix and i == len(q_words) - 1
                if not any(
                    self._word_matches(
                        qw, nw, prefix=last, distance=pattern.distance
                    )
                    for nw in node_words
                ):
                    return None
            return score + 1.0
        if match == "fuzzy":
            d = pattern.distance
            if pattern.prefix:
                lq = len(norm_q)
                for cut in range(max(lq - d, 0), lq + d + 1):
                    if osa_leq(norm_q, norm_v[:cut], d):
                        return score + 1.0
                return None
            if osa_leq(norm_q, norm_v, d):
                return score + 1.0
            return None
        # exact
        if pattern.prefix:
            if norm_v.startswith(norm_q):
                return score + 1.0
            return None
        if norm_v == norm_q:
            return score + 1.0
        return None

    @staticmethod
    def _word_matches(
        q: str, w: str, *, prefix: bool = False, distance: int = FUZZY_DISTANCE
    ) -> bool:
        if prefix:
            lq = len(q)
            return any(
                osa_leq(q, w[:cut], distance)
                for cut in range(max(lq - distance, 0), lq + distance + 1)
            )
        return osa_leq(q, w, distance)

    def _node_matches(self, pattern: NodePattern, value: str, ntype: str, subtype: str) -> bool:
        return self._node_score(pattern, value, ntype, subtype) is not None

    def _rel_score(self, pattern: RelationPattern, edge: dict) -> Optional[float]:
        """Score an edge's relation against a pattern; None = no match
        (scalar oracle)."""
        score = 0.0
        if pattern.relation is not None:
            if edge["relation"] != pattern.relation:
                return None
            score += 1.0
        if pattern.match == "semantic":
            sem = pattern.semantic_matches or {}
            s = sem.get(strip_diacritics(edge["label"].lower()))
            if s is None:
                return None
            return score + float(s)
        if pattern.label is not None:
            if edge["label"] != pattern.label:
                return None
            score += 1.0
        return score

    def _rel_matches(self, pattern: RelationPattern, edge: dict) -> bool:
        return self._rel_score(pattern, edge) is not None

    @staticmethod
    def _generated_score(q: dict, e: dict) -> Optional[float]:
        """Scalar-oracle twin of ``_generated_scores``."""
        facets = e.get("facets") or []
        by = q.get("by")
        if by == "user":
            return 0.0 if "/g/u" in facets else None
        if by == "processor":
            return None if any(f == "/g" or f.startswith("/g/") for f in facets) else 0.0
        if by == "data-augmentation":
            prefix = "/g/da"
            if q.get("da_task"):
                prefix = f"/g/da/{q['da_task']}"
            return 0.0 if any(f.startswith(prefix) for f in facets) else None
        raise ValueError(f"unsupported generated.by: {by!r}")

    def _compile_expr(self, q: dict) -> Callable[[dict], Optional[float]]:
        """Compile a boolean path-query tree into ``edge -> Optional[float]``
        — the scalar oracle for ``_eval_expr``."""
        if not isinstance(q, dict):
            raise ValueError(f"graph query node must be an object, got {q!r}")
        if "and" in q:
            preds = [self._compile_expr(x) for x in q["and"]]

            def and_pred(e, preds=preds):
                total = 0.0
                for p in preds:
                    s = p(e)
                    if s is None:
                        return None
                    total += s
                return total

            return and_pred
        if "or" in q:
            preds = [self._compile_expr(x) for x in q["or"]]

            def or_pred(e, preds=preds):
                total = None
                for p in preds:
                    s = p(e)
                    if s is not None:
                        total = (total or 0.0) + s
                return total

            return or_pred
        if "not" in q:
            pred = self._compile_expr(q["not"])
            return lambda e: None if pred(e) is not None else 0.0
        prop = q.get("prop")
        if prop == "path":
            src = self._leaf_node_pattern(q.get("source") or {})
            dst = self._leaf_node_pattern(q.get("destination") or {})
            rel_d = q.get("relation") or {}
            rel = RelationPattern(
                label=rel_d.get("label"),
                relation=rel_d.get("type"),
                match=rel_d.get("match", "exact"),
                semantic_matches=rel_d.get("semantic_matches"),
            )
            undirected = bool(q.get("undirected", False))

            def path_pred(e, src=src, dst=dst, rel=rel, undirected=undirected):
                rel_score = self._rel_score(rel, e)
                if rel_score is None:
                    return None
                s1 = self._node_score(
                    src, e["source_value"], e["source_type"], e["source_subtype"]
                )
                s2 = self._node_score(
                    dst, e["target_value"], e["target_type"], e["target_subtype"]
                )
                fwd = None if s1 is None or s2 is None else s1 + s2 + rel_score
                if not undirected:
                    return fwd
                s3 = self._node_score(
                    src, e["target_value"], e["target_type"], e["target_subtype"]
                )
                s4 = self._node_score(
                    dst, e["source_value"], e["source_type"], e["source_subtype"]
                )
                bwd = None if s3 is None or s4 is None else s3 + s4 + rel_score
                if fwd is None:
                    return bwd
                if bwd is None:
                    return fwd
                return max(fwd, bwd)

            return path_pred
        if prop in ("source_node", "destination_node", "node"):
            pat = self._leaf_node_pattern(q)

            def node_pred(e, pat=pat, prop=prop):
                at_source = self._node_score(
                    pat, e["source_value"], e["source_type"], e["source_subtype"]
                )
                at_target = self._node_score(
                    pat, e["target_value"], e["target_type"], e["target_subtype"]
                )
                if prop == "source_node":
                    return at_source
                if prop == "destination_node":
                    return at_target
                if at_source is None:
                    return at_target
                if at_target is None:
                    return at_source
                return at_source + at_target

            return node_pred
        if prop == "relation":
            rel = RelationPattern(
                label=q.get("label"),
                relation=q.get("type"),
                match=q.get("match", "exact"),
                semantic_matches=q.get("semantic_matches"),
            )
            return lambda e, rel=rel: self._rel_score(rel, e)
        if prop == "generated":
            return lambda e, q=q: self._generated_score(q, e)
        if prop == "facet":
            prefix = (q.get("facet", "") or "").rstrip("/")

            def facet_pred(e, prefix=prefix):
                facets = e.get("facets") or []
                return (
                    0.0
                    if any(f == prefix or f.startswith(prefix + "/") for f in facets)
                    else None
                )

            return facet_pred
        raise ValueError(f"unsupported graph query node: {q!r}")

    def _compile_node_expr(self, q: dict, position: str) -> Callable[[dict], Optional[float]]:
        """Scalar oracle for ``_eval_node_expr``."""
        if not isinstance(q, dict):
            raise ValueError(f"graph query node must be an object, got {q!r}")
        if "and" in q:
            preds = [self._compile_node_expr(x, position) for x in q["and"]]

            def and_pred(e, preds=preds):
                total = 0.0
                for p in preds:
                    s = p(e)
                    if s is None:
                        return None
                    total += s
                return total

            return and_pred
        if "or" in q:
            preds = [self._compile_node_expr(x, position) for x in q["or"]]

            def or_pred(e, preds=preds):
                total = None
                for p in preds:
                    s = p(e)
                    if s is not None:
                        total = (total or 0.0) + s
                return total

            return or_pred
        if "not" in q:
            pred = self._compile_node_expr(q["not"], position)
            return lambda e: None if pred(e) is not None else 0.0
        prop = q.get("prop")
        if prop == "node":
            pat = self._leaf_node_pattern(q)
            if position == "source":
                return lambda e, pat=pat: self._node_score(
                    pat, e["source_value"], e["source_type"], e["source_subtype"]
                )
            return lambda e, pat=pat: self._node_score(
                pat, e["target_value"], e["target_type"], e["target_subtype"]
            )
        if prop == "generated":
            return lambda e, q=q: self._generated_score(q, e)
        raise ValueError(f"unsupported graph nodes query leaf: {q!r}")

    # ---- public query surface (vectorized) ------------------------------

    def _path_from_edge(self, e: dict, score: float = 1.0) -> GraphPath:
        return GraphPath(
            source=GraphNode(e["source_value"], e["source_type"], e["source_subtype"]),
            relation=e["relation"],
            label=e["label"],
            target=GraphNode(e["target_value"], e["target_type"], e["target_subtype"]),
            metadata=e.get("metadata") or {},
            resource_field=e["key"],
            score=score,
            facets=list(e.get("facets") or []),
        )

    def _node_csr(self, side: str) -> tuple[np.ndarray, np.ndarray]:
        """(offsets [U+1], edge ids grouped by node) for one edge column."""
        cached = self._src_csr if side == "src" else self._dst_csr
        if cached is None:
            col = self._src_id if side == "src" else self._dst_id
            u = len(self._node_rows)
            order = np.argsort(col, kind="stable").astype(np.int64)
            counts = np.bincount(col, minlength=u)
            offsets = np.zeros(u + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            cached = (offsets, order)
            if side == "src":
                self._src_csr = cached
            else:
                self._dst_csr = cached
        return cached

    def _incident_edges(self, node_ids: np.ndarray, side: str) -> np.ndarray:
        offsets, order = self._node_csr(side)
        parts = [
            order[offsets[n]: offsets[n + 1]] for n in node_ids.tolist()
        ]
        return (
            np.concatenate(parts) if parts else np.zeros(0, np.int64)
        )

    def _pattern_candidate_node_ids(self, pattern: NodePattern):
        """Matched node-triple ids when the pattern resolves through the
        term dictionaries (exact / prefix / fuzzy d=1); None = the pattern
        needs the generic evaluator."""
        if pattern.value is None or pattern.match == "semantic":
            return None
        match = pattern.match
        if pattern.fuzzy and match == "exact":
            match = "fuzzy"
        norm_q = strip_diacritics(pattern.value.lower())
        if match == "exact" and not pattern.prefix:
            ids = self._value_postings().get(norm_q)
            ids = ids if ids is not None else np.zeros(0, np.int64)
        elif match == "exact" and pattern.prefix:
            ids = self._norm_range_ids(norm_q, norm_q + "\U0010ffff")
        elif match == "fuzzy" and not pattern.prefix and pattern.distance <= 1:
            from ..text_engine.fuzzy import MIN_FUZZY_LEN

            if len(norm_q) < MIN_FUZZY_LEN:
                return None
            vp = self._value_postings()
            parts = [
                vp[v] for v in self.fuzzy_index.expand(norm_q, 1) if v in vp
            ]
            ids = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        else:
            return None
        if pattern.ntype is not None and len(ids):
            ids = ids[self._n_types[ids] == pattern.ntype]
        if pattern.subtype is not None and pattern.subtype != "" and len(ids):
            ids = ids[self._n_subtypes[ids] == pattern.subtype]
        return ids

    # candidate sets above this stop paying off vs one dense [E] pass
    _SPARSE_NODE_MAX = 4096

    def graph_search(self, request: GraphSearchRequest) -> list[GraphPath]:
        """Single-hop path matching (parity: RelationSearcher::graph_search):
        first top_k matching edges in segment order, unscored.

        Sparse fast path: when the source (or target) pattern resolves to
        few node ids through the term dictionaries, only the incident edges
        (node->edge CSR) are evaluated — a selective path query costs the
        candidate set, not dense [E] column passes (the tantivy posting-
        intersection role, nidx_relation/src/reader.rs)."""
        if not self.edges:
            return []
        cand = self._path_candidates(
            request.source, request.target, request.undirected
        )
        if cand is not None and len(cand) <= len(self.edges) // 4:
            # np.unique output is ascending = segment order
            if len(cand) == 0:
                return []
            rel_s = self._rel_pattern_scores(request.relation)[
                self._rel_id[cand]
            ]
            s_src = self._node_pattern_scores(request.source)
            s_dst = self._node_pattern_scores(request.target)
            fwd = rel_s + s_src[self._src_id[cand]] + s_dst[self._dst_id[cand]]
            if request.undirected:
                bwd = (
                    rel_s
                    + s_src[self._dst_id[cand]]
                    + s_dst[self._src_id[cand]]
                )
                fwd = np.fmax(fwd, bwd)
            idx = cand[~np.isnan(fwd)][: request.top_k]
        else:
            scores = self._path_scores(
                request.source, request.relation, request.target,
                request.undirected,
            )
            idx = np.flatnonzero(~np.isnan(scores))[: request.top_k]
        out = []
        for i in idx:
            e = self.edges[int(i)]
            out.append(
                GraphPath(
                    source=GraphNode(e["source_value"], e["source_type"], e["source_subtype"]),
                    relation=e["relation"],
                    label=e["label"],
                    target=GraphNode(e["target_value"], e["target_type"], e["target_subtype"]),
                    metadata=e.get("metadata") or {},
                    resource_field=e["key"],
                )
            )
        return out

    def graph_search_expr(
        self, query: dict, top_k: int = 50, *, edge_ok=None
    ) -> list[GraphPath]:
        """Boolean path-query evaluation over the open edges, best-scored
        first (parity: reader.rs paths_graph_search with
        TopDocs::order_by_score). ``edge_ok`` (resource constraints) filters
        BEFORE the top_k cut so a constrained query still fills top_k."""
        scores = self._eval_expr(query)
        valid = np.flatnonzero(~np.isnan(scores))
        if valid.size == 0:
            return []
        order = np.lexsort(
            (self._key_rank[valid], -scores[valid].astype(np.float64))
        )
        ranked = valid[order]
        out: list[GraphPath] = []
        for i in ranked:
            e = self.edges[int(i)]
            if edge_ok is not None and not edge_ok(e):
                continue
            out.append(self._path_from_edge(e, score=float(scores[i])))
            if len(out) >= top_k:
                break
        return out

    def _edge_ok_indices(self, indices: np.ndarray, edge_ok) -> np.ndarray:
        """Filter matched edge indices through the caller's edge predicate
        (resource constraints) — applied post-match so the callable only
        runs on candidates."""
        if edge_ok is None:
            return indices
        keep = [i for i in indices if edge_ok(self.edges[int(i)])]
        return np.array(keep, dtype=np.int64)

    def nodes_search(
        self, query: dict, top_k: int = 50, *, edge_ok=None
    ) -> list[tuple[GraphNode, float]]:
        """Distinct-node projection (parity: reader.rs nodes_graph_search —
        the node expression is evaluated once with nodes AS SOURCE and once
        AS DESTINATION, unique nodes keep their best score, top-N by score).

        The query tree may contain ``node`` / ``generated`` leaves and
        and/or/not combinators (GraphNodesQuery). ``edge_ok`` optionally
        prefilters edges (resource constraints)."""
        U = len(self._node_rows)
        if edge_ok is None and isinstance(query, dict) and query.get("prop") == "node":
            # single node-leaf without edge constraints: the per-node best
            # score IS the node's own pattern score (every table node comes
            # from at least one edge, at whichever position the evaluator
            # would have found it) — no [E] passes at all
            sc = self._node_pattern_scores(self._leaf_node_pattern(query))
            combined = np.where(
                np.isnan(sc), -np.inf, sc.astype(np.float64)
            )
        else:
            combined = np.full(U, -np.inf, np.float64)
            for position in ("source", "destination"):
                sc = self._eval_node_expr(query, position)
                valid = self._edge_ok_indices(
                    np.flatnonzero(~np.isnan(sc)), edge_ok
                )
                if valid.size == 0:
                    continue
                ids = (
                    self._src_id if position == "source" else self._dst_id
                )[valid]
                np.maximum.at(combined, ids, sc[valid].astype(np.float64))
        cand = np.flatnonzero(combined > -np.inf)
        if cand.size == 0:
            return []
        # vectorized (-score, key) ranking: a precomputed lexicographic key
        # rank replaces the python dict + full sort over every matched node
        # (a type-only query matches ~25% of a 100k-node table — the sorted()
        # tail alone cost ~50 ms at 1M edges)
        order = np.lexsort((self._node_rank()[cand], -combined[cand]))[:top_k]
        sel = cand[order]
        return [
            (GraphNode(*self._node_rows[int(n)]), float(combined[n]))
            for n in sel
        ]

    def _node_rank(self) -> np.ndarray:
        """[U] lexicographic rank of each node triple (lazy, built once) —
        the vectorizable form of the (-score, key) tie order."""
        rank = getattr(self, "_node_rank_arr", None)
        if rank is None:
            order = sorted(range(len(self._node_rows)),
                           key=self._node_rows.__getitem__)
            rank = np.empty(len(order), np.int64)
            rank[order] = np.arange(len(order))
            self._node_rank_arr = rank
        return rank

    def relations_search(
        self, query: dict, top_k: int = 50, *, edge_ok=None
    ) -> list[tuple[str, str, float]]:
        """Distinct-relation projection (parity: reader.rs
        relations_graph_search + TopUniqueN): unique (type, label) pairs
        from edges matching the path query, best score kept."""
        if edge_ok is None and isinstance(query, dict) and query.get("prop") == "relation":
            # single relation-leaf without edge constraints: every table
            # relation originates from an edge, so the projection is a rank
            # over the relation pattern scores — no [E] pass
            rp = RelationPattern(
                label=query.get("label"),
                relation=query.get("type"),
                match=query.get("match", "exact"),
                semantic_matches=query.get("semantic_matches"),
            )
            rs = self._rel_pattern_scores(rp)
            best = {
                self._rel_rows[int(r)]: float(rs[r])
                for r in np.flatnonzero(~np.isnan(rs))
            }
            ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
            return [(rel, label, score) for (rel, label), score in ranked]
        sc = self._eval_expr(query)
        valid = self._edge_ok_indices(np.flatnonzero(~np.isnan(sc)), edge_ok)
        if valid.size == 0:
            return []
        R = len(self._rel_rows)
        acc = np.full(R, -np.inf, np.float64)
        np.maximum.at(acc, self._rel_id[valid], sc[valid].astype(np.float64))
        best: dict[tuple[str, str], float] = {}
        for rid in np.flatnonzero(acc > -np.inf):
            # matched edges keep whatever score they carry — semantic legs
            # can legitimately score below -1 (cosine/dot), and a match is
            # signalled by non-NaN, not by sign
            best[self._rel_rows[int(rid)]] = float(acc[rid])
        ranked = sorted(best.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]
        return [(rel, label, score) for (rel, label), score in ranked]

    def neighbours(self, entry_values: Sequence[str], top_k: int = 50) -> list[GraphPath]:
        """All paths touching any entry node (the /find relations feature).
        Served from the value dictionary + node->edge CSR — no [E] pass."""
        if not self.edges:
            return []
        vp = self._value_postings()
        nid_parts = [
            vp[n]
            for n in {strip_diacritics(v.lower()) for v in entry_values}
            if n in vp
        ]
        if not nid_parts:
            return []
        nids = np.unique(np.concatenate(nid_parts))
        inc = np.concatenate(
            [self._incident_edges(nids, s) for s in ("src", "dst")]
        )
        idx = np.unique(inc)[:top_k]  # ascending = segment order
        out = []
        for i in idx:
            e = self.edges[int(i)]
            out.append(
                GraphPath(
                    source=GraphNode(e["source_value"], e["source_type"], e["source_subtype"]),
                    relation=e["relation"],
                    label=e["label"],
                    target=GraphNode(e["target_value"], e["target_type"], e["target_subtype"]),
                    metadata=e.get("metadata") or {},
                    resource_field=e["key"],
                )
            )
        return out

    def suggest_nodes(self, prefix: str, top_k: int = 10) -> list[GraphNode]:
        """Entity suggest: prefix match (+fuzzy fallback) over node values.

        Parity: nidx_relation suggest (lib.rs:217-262).
        """
        norm = strip_diacritics(prefix.lower())
        seen: dict[str, GraphNode] = {}
        import bisect

        lo = bisect.bisect_left(self._norm_values, norm)
        for i in range(lo, min(lo + top_k * 2, len(self.node_values))):
            if not self._norm_values[i].startswith(norm):
                break
            seen.setdefault(self.node_values[i], self._make_node(self.node_values[i]))
        if len(seen) < top_k and len(norm) > 2:
            for cand in self.fuzzy_index.expand(norm, FUZZY_DISTANCE):
                idx = self._norm_values.index(cand)
                value = self.node_values[idx]
                seen.setdefault(value, self._make_node(value))
        return list(seen.values())[:top_k]

    def _make_node(self, value: str) -> GraphNode:
        ts = self._value_ts.get(value)
        if ts is not None:
            return GraphNode(value, ts[0], ts[1])
        return GraphNode(value, "ENTITY", "")

"""Fuzzy term expansion via deletion neighborhoods (SymSpell scheme).

Copy of ``nucliadb_tpu/index/text_engine/fuzzy.py`` (importing that module
imports jax through its package).

The reference matches query terms fuzzily with Levenshtein distance 1 and
transpositions costing 1 (nidx_paragraph/src/query_parser/fuzzy_parser.rs:72
``transposition_cost_one = true``; nidx_relation FUZZY_DISTANCE=1) using
tantivy's Levenshtein automata over its FST term dictionary, and only for
tokens of >= MIN_FUZZY_LEN chars (fuzzy_parser.rs:35,76 — shorter tokens
match exactly "to avoid noise"). Without an FST, the equivalent
constant-time scheme is the deletion neighborhood: two terms within OSA
distance 1 always share a member of each other's {self} ∪ {single-char
deletions} sets (a transposition's two one-char deletions overlap both
sides). We precompute the deletion variants of every vocabulary term once
at consolidation; a query term then expands with pure dict lookups, each
candidate verified with a real OSA edit-distance check.
"""

from __future__ import annotations

# tokens shorter than this match exactly, never fuzzily (parity:
# nidx_paragraph/src/query_parser/fuzzy_parser.rs:35 MIN_FUZZY_LEN)
MIN_FUZZY_LEN = 3


def _deletes(term: str) -> set[str]:
    return {term[:i] + term[i + 1 :] for i in range(len(term))}


def levenshtein_leq(a: str, b: str, d: int) -> bool:
    """Banded edit-distance check: distance(a, b) <= d."""
    if abs(len(a) - len(b)) > d:
        return False
    if a == b:
        return True
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        lo = max(1, i - d)
        hi = min(len(b), i + d)
        if lo > 1:
            cur[lo - 1] = d + 1
        for j in range(lo, hi + 1):
            cost = 0 if ca == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if hi < len(b):
            cur[hi + 1 :] = [d + 1] * (len(b) - hi)
        if min(cur[max(0, lo - 1) : hi + 1]) > d:
            return False
        prev = cur
    return prev[len(b)] <= d


def _osa_leq1(a: str, b: str) -> bool:
    """OSA distance(a, b) <= 1, specialized: one substitution, insertion,
    deletion or adjacent transposition. O(n) with C-level slice compares —
    the d=1 verification is the hottest loop of fuzzy search (the product
    path is always d=1, reference FUZZY_DISTANCE=1) and the full DP spent
    ~2.5 ms/query on it."""
    la, lb = len(a), len(b)
    if la == lb:
        if a == b:
            return True
        i = 0
        while a[i] == b[i]:
            i += 1
        if a[i + 1:] == b[i + 1:]:
            return True  # one substitution
        return (
            i + 1 < la
            and a[i] == b[i + 1]
            and a[i + 1] == b[i]
            and a[i + 2:] == b[i + 2:]
        )  # one adjacent transposition
    if la > lb:
        a, b, la, lb = b, a, lb, la
    if lb - la != 1:
        return False
    i = 0
    while i < la and a[i] == b[i]:
        i += 1
    return a[i:] == b[i + 1:]  # one insertion into the shorter


def osa_leq(a: str, b: str, d: int) -> bool:
    """Restricted-Damerau (OSA) check: distance(a, b) <= d with adjacent
    transpositions costing 1 — tantivy's ``transposition_cost_one = true``
    semantics (nidx_paragraph/src/query_parser/fuzzy_parser.rs:73)."""
    if d == 1:
        return _osa_leq1(a, b)
    if abs(len(a) - len(b)) > d:
        return False
    if a == b:
        return True
    # full DP: only runs on deletion-neighborhood candidates (short strings)
    la, lb = len(a), len(b)
    prev2: list[int] | None = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            best = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (
                i > 1
                and j > 1
                and a[i - 1] == b[j - 2]
                and a[i - 2] == b[j - 1]
            ):
                best = min(best, prev2[j - 2] + 1)
            cur[j] = best
        prev2, prev = prev, cur
    return prev[lb] <= d


class FuzzyIndex:
    """Deletion-neighborhood index over a vocabulary.

    The symmetric-delete scheme is complete for distance d only when BOTH
    sides contribute deletion variants to depth d (a term 2 chars longer
    than the token needs two deletions to reach their common ancestor), so
    the stored depth bounds the answerable distance: ``expand`` clamps to
    ``max_distance`` rather than returning a silently incomplete
    neighborhood. The product path is d=1 (reference FUZZY_DISTANCE=1);
    depth 2 is opt-in because it stores ~len(term)^2/2 variants per term.
    """

    def __init__(self, terms: list[str], max_distance: int = 1):
        self.terms = terms
        self.max_distance = max_distance
        self._term_set = set(terms)
        self.variant_map: dict[str, list[int]] = {}
        for idx, term in enumerate(terms):
            variants = {term}
            frontier = {term}
            for _ in range(max_distance):
                frontier = {v for f in frontier for v in _deletes(f)}
                variants |= frontier
            for variant in variants:
                self.variant_map.setdefault(variant, []).append(idx)
        # expansion memo: term distributions are zipfian, so serving repeats
        # the same probes constantly; the vocabulary is immutable per index
        self._cache: dict[tuple[str, int], list[str]] = {}

    _CACHE_MAX = 20_000

    def expand(self, token: str, distance: int = 1) -> list[str]:
        """Vocabulary terms within edit distance of the token."""
        key = (token, distance)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        out = self._expand_uncached(token, distance)
        if len(self._cache) < self._CACHE_MAX:
            self._cache[key] = out
        return out

    def _expand_uncached(self, token: str, distance: int) -> list[str]:
        distance = min(distance, self.max_distance)
        if distance <= 0:
            return [token] if token in self._term_set else []
        if len(token) < MIN_FUZZY_LEN:
            # short tokens match exactly only (fuzzy_parser.rs:76)
            return [token] if token in self._term_set else []
        probes = {token}
        frontier = {token}
        for _ in range(distance):
            frontier = {v for f in frontier for v in _deletes(f)}
            probes |= frontier
        cand_ids: set[int] = set()
        for probe in probes:
            cand_ids.update(self.variant_map.get(probe, ()))
        out = []
        for idx in cand_ids:
            term = self.terms[idx]
            if osa_leq(token, term, distance):
                out.append(term)
        return sorted(out)


def fuzzy_expand(token: str, fuzzy_index: "FuzzyIndex", distance: int = 1) -> list[str]:
    return fuzzy_index.expand(token, distance)

"""The scenarios of ``tests/test_query_language_fuzz.py`` on the port: the port's ``query_language``.

The reference file's own docstring:

Randomized equivalence tests for the boolean filter engine.

The reference's FilterBitSet/Formula evaluator (nidx_vector inverted_index +
formula.rs) is exercised by every index; here random expression trees are
checked against a naive per-record oracle, for both the bitset evaluator
(kernel masks) and the single-record evaluator (external-index post-filter).
"""

import numpy as np
import pytest

from nucliadb_tpu_torch.query_language import (
    And,
    FacetPrefixAtom,
    KeyPrefixAtom,
    LabelAtom,
    Not,
    Or,
    evaluate_bitset,
    evaluate_one,
)

LABELS = [f"/l/set{i}/v{j}" for i in range(3) for j in range(3)] + [
    "/e/person/ada", "/n/s/PROCESSED",
]


def random_expr(rng, depth=0):
    roll = rng.random()
    if depth >= 3 or roll < 0.45:
        kind = rng.integers(0, 3)
        if kind == 0:
            return LabelAtom(LABELS[rng.integers(0, len(LABELS))])
        if kind == 1:
            return KeyPrefixAtom(tuple(
                f"r{int(rng.integers(0, 8))}/" for _ in range(int(rng.integers(1, 3)))
            ))
        return FacetPrefixAtom(f"/l/set{int(rng.integers(0, 3))}")
    ops = [random_expr(rng, depth + 1) for _ in range(int(rng.integers(1, 4)))]
    if roll < 0.65:
        return And(tuple(ops))
    if roll < 0.85:
        return Or(tuple(ops))
    return Not(ops[0])


def naive_match(expr, labels: set, key: str) -> bool:
    if isinstance(expr, LabelAtom):
        return expr.label in labels
    if isinstance(expr, KeyPrefixAtom):
        return any(key.startswith(p) for p in expr.prefixes)
    if isinstance(expr, FacetPrefixAtom):
        facet = expr.facet.rstrip("/")
        return any(l == facet or l.startswith(facet + "/") for l in labels)
    if isinstance(expr, And):
        return all(naive_match(op, labels, key) for op in expr.operands)
    if isinstance(expr, Or):
        return any(naive_match(op, labels, key) for op in expr.operands)
    if isinstance(expr, Not):
        return not naive_match(expr.operand, labels, key)
    raise TypeError(expr)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_bitset_and_one_record_agree_with_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 64
    keys = [f"r{int(rng.integers(0, 8))}/t/f{i}" for i in range(n)]
    record_labels = [
        {LABELS[j] for j in rng.choice(len(LABELS), rng.integers(0, 5), replace=False)}
        for _ in range(n)
    ]

    def resolver(atom):
        return np.array(
            [i for i in range(n) if naive_match(atom, record_labels[i], keys[i])],
            dtype=np.int64,
        )

    for _ in range(25):
        expr = random_expr(rng)
        mask = evaluate_bitset(expr, n, resolver)
        expect = np.array(
            [naive_match(expr, record_labels[i], keys[i]) for i in range(n)]
        )
        np.testing.assert_array_equal(mask, expect)
        # the single-record evaluator agrees record by record
        for i in range(0, n, 7):
            assert evaluate_one(expr, record_labels[i], key=keys[i]) == bool(expect[i])


def test_none_expression_matches_everything():
    assert evaluate_bitset(None, 4, lambda a: []).all()
    assert evaluate_one(None, set(), key="")

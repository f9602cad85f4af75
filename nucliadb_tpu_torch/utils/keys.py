"""Key-prefix matching with path-segment boundaries (single implementation).

The port's copy of ``nucliadb_tpu/utils/keys.py``, kept verbatim: the port
imports nothing of the JAX package.

Deletion keys and prefilter field ids address key *subtrees*:
``rid`` or ``rid/field`` must match the exact key and everything under
``rid/field/...`` — but never a sibling sharing a string prefix
(``rid/f1`` must not match ``rid/f10``). A prefix that already ends with
``/`` keeps plain string-prefix semantics (the whole-resource ``rid/`` form).

Used by every index's deletion mask, the vector/paragraph prefilter handoff
and the text engines' key filters (previously three inline copies of the
bisect trick — and all of them boundary-unaware).
"""

from __future__ import annotations

import bisect
from typing import Iterable, Sequence

def _subtree_hi(prefix_slash: str) -> str:
    """Exclusive upper bound for all keys starting with ``prefix + '/'``.

    Incrementing the trailing '/' (0x2F) to '0' (0x30) bounds the subtree
    exactly for every following code point — a U+FFFF sentinel would exclude
    keys whose next character is an astral-plane code point (> U+FFFF).
    """
    return prefix_slash[:-1] + "0"


def key_matches_prefix(key: str, prefix: str) -> bool:
    if prefix.endswith("/"):
        return key.startswith(prefix)
    return key == prefix or key.startswith(prefix + "/")


def key_prefix_ranges(
    sorted_keys: Sequence[str],
    prefixes: Iterable[str],
    bounds: Sequence[tuple[int, int]] | None = None,
) -> Iterable[tuple[int, int]]:
    """Yield [lo, hi) ranges of sorted keys matching each prefix.

    ``bounds`` lists [lo, hi) runs that are EACH sorted (consolidated
    engines concatenate per-segment sorted key lists — a later segment's
    keys can sort below an earlier segment's, so a global bisect over the
    concatenation silently matches the wrong rows). Without bounds the whole
    sequence must be sorted.
    """
    runs = bounds if bounds is not None else [(0, len(sorted_keys))]
    for prefix in prefixes:
        if prefix.endswith("/"):
            spans = [(prefix, _subtree_hi(prefix))]
        else:
            # exact key, then the '/' subtree (keys sorting between them,
            # like 'rid/f1!', are correctly excluded)
            spans = [(prefix, prefix + "\x00"), (prefix + "/", _subtree_hi(prefix + "/"))]
        for run_lo, run_hi in runs:
            for lo_key, hi_key in spans:
                lo = bisect.bisect_left(sorted_keys, lo_key, run_lo, run_hi)
                hi = bisect.bisect_left(sorted_keys, hi_key, run_lo, run_hi)
                if hi > lo:
                    yield lo, hi

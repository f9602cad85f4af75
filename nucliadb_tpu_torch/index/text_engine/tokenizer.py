"""Tokenization: lowercase word splitting.

Copy of ``nucliadb_tpu/index/text_engine/tokenizer.py`` (importing that
module imports jax through its package): the same rules, the native
tokenizer when ``nucliadb_tpu_native`` loads and the Python one otherwise.

Covers the role of tantivy's default tokenizer pipeline (SimpleTokenizer +
LowerCaser + RemoveLongFilter(40)) the reference indexes with. Exact rules
(shared byte-for-byte by the native C++ builder and this fallback — an
index must be buildable and queryable by either):

- word characters: ASCII [A-Za-z0-9_] and every non-ASCII character
  (non-ASCII scripts stay intact; non-ASCII punctuation is treated as part
  of adjacent words — a deliberate simplification over full Unicode
  word-boundary tables),
- ASCII letters lowercased, non-ASCII left untouched,
- tokens longer than 40 chars dropped but still advancing the position
  ordinal (phrase positions stay stable).
"""

from __future__ import annotations

import re
import unicodedata

try:  # native fast path (see native/postings.cpp); built via native/build.py
    import nucliadb_tpu_native as _native
except ImportError:  # pure-Python fallback with matching semantics
    _native = None

# mirror of the native word-byte rule: ASCII alnum + '_' + any non-ASCII
_WORD_RE = re.compile("[0-9A-Za-z_" + "\u0080" + "-" + "\U0010ffff" + "]+")
MAX_TOKEN_LEN = 40

_ASCII_LOWER = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz"
)


def _normalize(token: str) -> str:
    return token.translate(_ASCII_LOWER)  # ASCII-only lowering (native parity)


def tokenize(text: str) -> list[str]:
    if _native is not None:
        return [t for t, _ in _native.tokenize_with_positions(text)]
    return [t for t, _ in tokenize_with_positions(text)]


def tokenize_with_positions(text: str) -> list[tuple[str, int]]:
    """(token, ordinal position) pairs — positions are token ordinals.

    Byte-for-byte parity with the native tokenizer is a correctness
    invariant (an index built by one path is queried through the other):
    the length cap counts UTF-8 BYTES like the C++ does, and no extra
    filters exist on either side.
    """
    if _native is not None:
        return _native.tokenize_with_positions(text)
    out = []
    pos = 0
    for m in _WORD_RE.finditer(text):
        tok = m.group(0)
        if len(tok.encode("utf-8")) > MAX_TOKEN_LEN:
            pos += 1
            continue
        out.append((_normalize(tok), pos))
        pos += 1
    return out


def strip_diacritics(text: str) -> str:
    """ASCII-folding used for suggest/fuzzy normalization."""
    return "".join(
        c for c in unicodedata.normalize("NFD", text) if unicodedata.category(c) != "Mn"
    )

"""Shared BM25 full-text engine for the text and paragraph indexes.

Counterpart of ``nucliadb_tpu/index/text_engine``:

- host: tokenizer, per-segment CSR postings builder (the same segment
  files), term dictionaries, fuzzy (OSA) expansion, phrase verification
  via positions, facet counting, and the host WAND tier;
- device: BM25 scoring over tiered postings per group (row gathers + one
  scatter-add per slot) with dense tf columns for stopword-grade terms
  (``ops/bm25.py``), on an explicit torch ``device``.
"""

from .tokenizer import tokenize, tokenize_with_positions
from .builder import TextSegmentData, build_segment, open_text_segment
from .engine import DeviceTextEngine, TextQuery, TextHit

__all__ = [
    "tokenize",
    "tokenize_with_positions",
    "TextSegmentData",
    "build_segment",
    "open_text_segment",
    "DeviceTextEngine",
    "TextQuery",
    "TextHit",
]

"""Vector index configuration.

A copy of ``nucliadb_tpu/index/vector/config.py``: importing anything under
``nucliadb_tpu.index.vector`` imports jax, so the port keeps its own. Both
write and read the same ``meta.json`` dicts (``to_dict`` / ``from_dict``).

Parity with the reference's ``VectorConfig``
(nidx_vector/src/config.rs:102-124): similarity, normalization, cardinality
(single vs multivector), experiment flags, and an explicit codec choice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class Similarity(str, Enum):
    DOT = "dot"
    COSINE = "cosine"


class VectorCardinality(str, Enum):
    SINGLE = "single"
    MULTI = "multi"  # multivector (MaxSim) — reference config.rs VectorCardinality


class Quantization(str, Enum):
    NONE = "none"  # exact f32 scan only
    INT8 = "int8"  # 4x compression, int8 scan, ~0.99 recall before rerank
    BINARY = "binary"  # 32x compression, popcount scan (RaBitQ analogue)


# Segments below this many vectors skip quantized scanning entirely: the
# exact matmul is already sub-millisecond and avoids double work. The
# analogue of the reference's HNSW-vs-brute-force cost model
# (nidx_vector/src/segment.rs:626-660).
EXACT_SCAN_THRESHOLD = 131_072


@dataclass
class VectorConfig:
    dimension: int
    similarity: Similarity = Similarity.DOT
    normalize_vectors: bool = False
    cardinality: VectorCardinality = VectorCardinality.SINGLE
    quantization: Quantization = Quantization.INT8
    flags: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if isinstance(self.similarity, str):
            self.similarity = Similarity(self.similarity)
        if isinstance(self.cardinality, str):
            self.cardinality = VectorCardinality(self.cardinality)
        if isinstance(self.quantization, str):
            self.quantization = Quantization(self.quantization)
        if self.quantization == Quantization.BINARY and self.dimension % 32 != 0:
            # binary codes need dim % 32 (reference requires % 64, config.rs:170)
            self.quantization = Quantization.INT8

    @property
    def normalize(self) -> bool:
        # cosine is implemented as dot over normalized vectors
        return self.normalize_vectors or self.similarity == Similarity.COSINE

    def to_dict(self) -> dict[str, Any]:
        return {
            "dimension": self.dimension,
            "similarity": self.similarity.value,
            "normalize_vectors": self.normalize_vectors,
            "cardinality": self.cardinality.value,
            "quantization": self.quantization.value,
            "flags": list(self.flags),
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "VectorConfig":
        return VectorConfig(
            dimension=int(d["dimension"]),
            similarity=Similarity(d.get("similarity", "dot")),
            normalize_vectors=bool(d.get("normalize_vectors", False)),
            cardinality=VectorCardinality(d.get("cardinality", "single")),
            quantization=Quantization(d.get("quantization", "int8")),
            flags=list(d.get("flags", [])),
        )

"""External index providers: plug a third-party index in place of the node.

The port's copy of ``nucliadb_tpu/common/external_index.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's external index plugin seam
(nucliadb/src/nucliadb/common/external_index_providers/base.py:126): a KB
can route vector indexing + querying to an external service (the reference
ships a Pinecone provider); everything else (text, metadata) stays local.
Providers register by name; the KB records its provider in KV config.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional, Type

import numpy as np

from ..models.internal import ResourceDoc


@dataclass
class ExternalHit:
    key: str
    score: float
    metadata: dict


class ExternalIndexManager(ABC):
    """One external vector index bound to one KB."""

    provider_name: str = "abstract"

    @abstractmethod
    def index_resource(self, resource: ResourceDoc, vectorset: str) -> None: ...

    @abstractmethod
    def delete_resource(self, resource_id: str) -> None: ...

    @abstractmethod
    def query(
        self, vector: np.ndarray, top_k: int, *, filter_labels: Optional[list[str]] = None
    ) -> list[ExternalHit]: ...


_PROVIDERS: dict[str, Type[ExternalIndexManager]] = {}


def register_provider(cls: Type[ExternalIndexManager]) -> Type[ExternalIndexManager]:
    _PROVIDERS[cls.provider_name] = cls
    return cls


def get_provider(name: str) -> Type[ExternalIndexManager]:
    if name not in _PROVIDERS:
        raise KeyError(
            f"unknown external index provider {name!r}; registered: {sorted(_PROVIDERS)}"
        )
    return _PROVIDERS[name]


@register_provider
class InMemoryExternalIndex(ExternalIndexManager):
    """Reference implementation of the seam (and the test double): a plain
    in-process exact-scan index with label filtering."""

    provider_name = "memory"

    def __init__(self, **_config):
        self._vectors: dict[str, np.ndarray] = {}
        self._labels: dict[str, list[str]] = {}

    def index_resource(self, resource: ResourceDoc, vectorset: str) -> None:
        for fid, paragraphs in resource.paragraphs.items():
            for para in paragraphs.values():
                for key, sentence in para.vectorsets_sentences.get(vectorset, {}).items():
                    self._vectors[key] = np.asarray(sentence.vector, np.float32)
                    self._labels[key] = list(resource.labels) + list(para.labels)

    def delete_resource(self, resource_id: str) -> None:
        prefix = resource_id + "/"
        for key in [k for k in self._vectors if k.startswith(prefix)]:
            self._vectors.pop(key, None)
            self._labels.pop(key, None)

    def query(self, vector, top_k, *, filter_labels=None):
        out = []
        for key, v in self._vectors.items():
            if filter_labels and not set(filter_labels) & set(self._labels.get(key, [])):
                continue
            out.append(
                ExternalHit(
                    key=key,
                    score=float(v @ np.asarray(vector, np.float32)),
                    # providers return stored labels so the find leg can
                    # post-filter (security/filters) host-side
                    metadata={"labels": list(self._labels.get(key, []))},
                )
            )
        return sorted(out, key=lambda h: -h.score)[:top_k]

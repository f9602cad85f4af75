"""Per-shard index dispatch: one resource -> one new segment per index.

The port's copy of ``nucliadb_tpu/shard/indexer.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's indexer fan-out
(nidx/src/indexer.rs:298-419 index_resource + the IndexKind dispatch):
for every index of the shard, build a segment from the resource (None when
the resource contributes nothing) and collect the deletion keys that this
operation implies for that index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from ..index.json import JsonIndexer
from ..index.paragraph import ParagraphIndexer
from ..index.relation import RelationIndexer
from ..index.text import TextIndexer
from ..index.vector import VectorIndexer
from ..models.internal import ResourceDoc
from ..types import IndexKind, SegmentMetadata
from .config import ShardConfig


@dataclass
class IndexOp:
    """Result of indexing one resource into one index."""

    kind: IndexKind
    index_name: str  # kind value, or "vector/{vectorset}"
    segment: Optional[SegmentMetadata]
    deletions: list[str]


def _observed(kind: str, fn, *args, **kwargs):
    from ..telemetry.metrics import indexing_observer

    with indexing_observer({"kind": kind}):
        return fn(*args, **kwargs)


class ShardIndexer:
    def __init__(self, config: ShardConfig):
        self.config = config
        self.text = TextIndexer()
        self.paragraph = ParagraphIndexer()
        self.relation = RelationIndexer()
        self.json = JsonIndexer()

    def index_resource(
        self, resource: ResourceDoc, work_dir: str, *, hidden: bool = False
    ) -> list[IndexOp]:
        """Build one segment per affected index under ``work_dir``.

        Per-kind build counters/durations land in the prometheus registry
        (parity: nidx per-index-kind indexing metrics, indexer.rs:414-416).
        """
        ops: list[IndexOp] = []
        ops.append(
            IndexOp(
                kind=IndexKind.TEXT,
                index_name="text",
                segment=_observed(
                    "text", self.text.index_resource,
                    resource, os.path.join(work_dir, "text"),
                ),
                deletions=self.text.deletions_for_resource(resource),
            )
        )
        ops.append(
            IndexOp(
                kind=IndexKind.PARAGRAPH,
                index_name="paragraph",
                segment=_observed(
                    "paragraph", self.paragraph.index_resource,
                    resource, os.path.join(work_dir, "paragraph"),
                ),
                deletions=self.paragraph.deletions_for_resource(resource),
            )
        )
        ops.append(
            IndexOp(
                kind=IndexKind.RELATION,
                index_name="relation",
                segment=_observed(
                    "relation", self.relation.index_resource,
                    resource, os.path.join(work_dir, "relation"),
                ),
                deletions=self.relation.deletions_for_resource(resource),
            )
        )
        ops.append(
            IndexOp(
                kind=IndexKind.JSON,
                index_name="json",
                segment=_observed(
                    "json", self.json.index_resource,
                    resource, os.path.join(work_dir, "json"),
                ),
                deletions=self.json.deletions_for_resource(resource),
            )
        )
        for vs_name, vs_config in self.config.vectorsets.items():
            vi = VectorIndexer(vs_config)
            ops.append(
                IndexOp(
                    kind=IndexKind.VECTOR,
                    index_name=f"vector/{vs_name}",
                    segment=_observed(
                        "vector", vi.index_resource,
                        resource,
                        vs_name,
                        os.path.join(work_dir, f"vector_{vs_name}"),
                        hidden=hidden,
                    ),
                    deletions=vi.deletions_for_resource(resource, vs_name),
                )
            )
        return ops

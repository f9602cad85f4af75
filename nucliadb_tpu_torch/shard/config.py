"""Shard configuration: which indexes exist and how they are configured.

The port's copy of ``nucliadb_tpu/shard/config.py``,
kept verbatim: the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..index.vector.config import VectorConfig


@dataclass
class ShardConfig:
    shard_id: str
    kbid: str = ""
    # vectorset name -> vector index configuration
    vectorsets: dict[str, VectorConfig] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {
            "shard_id": self.shard_id,
            "kbid": self.kbid,
            "vectorsets": {k: v.to_dict() for k, v in self.vectorsets.items()},
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ShardConfig":
        return ShardConfig(
            shard_id=d["shard_id"],
            kbid=d.get("kbid", ""),
            vectorsets={
                k: VectorConfig.from_dict(v) for k, v in d.get("vectorsets", {}).items()
            },
        )

"""Environment-driven settings.

The port's copy of ``nucliadb_tpu/settings.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's config system (SURVEY §5.6): nidx's nested
env settings (nidx/src/settings.rs:357-409, e.g. ``INDEXER__OBJECT_STORE``)
and the pydantic BaseSettings per Python package. pydantic-settings is not
in the image, so a small loader maps ``NDBTPU_<SECTION>__<FIELD>`` env vars
onto nested pydantic models.
"""

from __future__ import annotations

import os
from typing import Optional, Type, TypeVar

from pydantic import BaseModel, Field

ENV_PREFIX = "NDBTPU_"


class IndexerSettings(BaseModel):
    work_dir: str = "./data/indexer"


class SchedulerSettings(BaseModel):
    # merge policy knobs (defaults parity: nidx/src/settings.rs:228-277)
    min_segments_to_merge: int = 4
    log_top_records: int = 10_000_000
    log_bottom_records: int = 10_000
    vector_small_threshold: int = 20_000
    vector_max_segment: int = 200_000
    tick_interval_s: float = 15.0


class SearcherSettings(BaseModel):
    # sync cadence parity: settings.rs:301-315
    metadata_refresh_s: float = 60.0
    parallel_syncs: int = 3
    cache_dir: str = "./data/segments"


class StorageSettings(BaseModel):
    backend: str = "local"  # local | memory | s3 | gcs | azure
    root: str = "./data/blobs"  # local backend
    # cloud backends (parity: nucliadb_utils/storages/settings.py and
    # nidx INDEXER__OBJECT_STORE settings)
    endpoint: str = ""  # custom endpoint (MinIO, fake-gcs, azurite)
    key_prefix: str = ""
    bucket: str = ""  # s3 | gcs
    access_key: str = ""  # s3
    secret_key: str = ""  # s3
    region: str = "us-east-1"  # s3
    token: str = ""  # gcs static bearer (else anonymous/metadata)
    account: str = ""  # azure
    account_key: str = ""  # azure
    container: str = ""  # azure


class TelemetrySettings(BaseModel):
    metrics_port: int = 10010
    log_level: str = "INFO"


class HTTPSettings(BaseModel):
    host: str = "0.0.0.0"
    port: int = 8080


class Settings(BaseModel):
    data_dir: str = "./data"
    indexer: IndexerSettings = Field(default_factory=IndexerSettings)
    scheduler: SchedulerSettings = Field(default_factory=SchedulerSettings)
    searcher: SearcherSettings = Field(default_factory=SearcherSettings)
    storage: StorageSettings = Field(default_factory=StorageSettings)
    telemetry: TelemetrySettings = Field(default_factory=TelemetrySettings)
    http: HTTPSettings = Field(default_factory=HTTPSettings)
    # feature flags (parity: nucliadb_utils featureflagging + nidx config
    # string flags like disable_rabitq_search)
    flags: list[str] = Field(default_factory=list)

    def has_flag(self, name: str) -> bool:
        return name in self.flags


def from_env(environ: Optional[dict] = None) -> Settings:
    """``NDBTPU_SECTION__FIELD=value`` / ``NDBTPU_FIELD=value`` -> Settings."""
    environ = dict(os.environ if environ is None else environ)
    data: dict = {}
    for key, value in environ.items():
        if not key.startswith(ENV_PREFIX):
            continue
        path = key[len(ENV_PREFIX):].lower().split("__")
        cursor = data
        for part in path[:-1]:
            cursor = cursor.setdefault(part, {})
        leaf = path[-1]
        if leaf == "flags":
            cursor[leaf] = [f for f in value.split(",") if f]
        else:
            cursor[leaf] = value
    return Settings.model_validate(data)

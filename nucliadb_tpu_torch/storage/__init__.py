"""Object storage: segments and resource blobs.

The port's copy of ``nucliadb_tpu/storage/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's object-store abstraction
(nidx/src/segment_store.rs + nucliadb_utils/storages/): a Storage interface
with local-filesystem, in-memory, S3, GCS, and Azure Blob backends. The
in-memory one mirrors the reference's test setup (nidx/tests using
object_store::memory); the cloud ones speak each provider's REST protocol
directly (no cloud SDKs in this image) and are exercised against in-process
protocol fakes in tests.
"""

from __future__ import annotations

from .storage import LocalStorage, MemoryStorage, Storage


def make_storage(settings) -> Storage:
    """Build a Storage from StorageSettings (parity: reference
    nucliadb_utils/storages/settings.py + get_storage factory)."""
    backend = settings.backend
    if backend == "local":
        return LocalStorage(settings.root)
    if backend == "memory":
        return MemoryStorage()
    if backend == "s3":
        from .s3 import S3Storage

        return S3Storage(
            settings.endpoint or "https://s3.amazonaws.com",
            settings.bucket,
            settings.access_key,
            settings.secret_key,
            region=settings.region,
            prefix=settings.key_prefix,
        )
    if backend == "gcs":
        from .gcs import GCSStorage

        token = settings.token
        return GCSStorage(
            settings.bucket,
            endpoint=settings.endpoint or "https://storage.googleapis.com",
            token_provider=(lambda: token) if token else None,
            prefix=settings.key_prefix,
        )
    if backend == "azure":
        from .azure import AzureStorage

        return AzureStorage(
            settings.account,
            settings.account_key,
            settings.container,
            endpoint=settings.endpoint or None,
            prefix=settings.key_prefix,
        )
    raise ValueError(f"unknown storage backend: {backend}")


__all__ = ["Storage", "LocalStorage", "MemoryStorage", "make_storage"]

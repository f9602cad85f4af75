"""Object storage: segments and resource blobs.

Counterpart of ``nucliadb_tpu/storage/__init__.py``: the same ``Storage``
interface with its local-filesystem and in-memory backends, and the segment
pack/unpack of ``storage.py`` (a verbatim copy). The S3, GCS and Azure
backends speak their providers' REST protocols through ``httpx`` and are
not ported yet (ROADMAP.md, Queue 1 item 10b): ``make_storage`` refuses
them.
"""

from __future__ import annotations

from .storage import LocalStorage, MemoryStorage, Storage

_REMOTE = ("s3", "gcs", "azure")


def make_storage(settings) -> Storage:
    """Build a Storage from settings with ``backend`` ("local", "memory")
    and ``root``."""
    backend = settings.backend
    if backend == "local":
        return LocalStorage(settings.root)
    if backend == "memory":
        return MemoryStorage()
    if backend in _REMOTE:
        raise NotImplementedError(
            f"the {backend} storage backend is not ported yet (it needs httpx; "
            "ROADMAP.md, Queue 1 item 10b)"
        )
    raise ValueError(f"unknown storage backend: {backend}")


__all__ = ["Storage", "LocalStorage", "MemoryStorage", "make_storage"]

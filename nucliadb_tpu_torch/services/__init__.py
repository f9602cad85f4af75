"""Index node services: indexer, scheduler, worker, searcher.

Counterpart of ``nucliadb_tpu/services/__init__.py``. The indexer, scheduler
and worker are copies of the JAX package's (host work: segment builds,
merges, the sqlite metadata); the searcher and the embedded node are ports
that take an explicit torch ``device``.

The reference's independently deployable nidx components
(nidx/README.md:11-19, nidx/src/main.rs:130-153) map onto:

- ``IndexerService``   — consumes index operations, builds one segment per
  affected index, uploads, commits metadata atomically (indexer.rs:298-378)
- ``SchedulerService`` — merge planning from the ack floor (log merge +
  vector merge policies), purge loops (scheduler.rs, scheduler/*.rs)
- ``WorkerService``    — leases merge jobs, downloads operants, merges,
  uploads + swaps (worker.rs:42-343)
- ``SyncedSearcher``   — syncs changed indexes to a local segment cache and
  serves shard searches from consolidated device arenas (searcher/)
- ``EmbeddedNode``     — everything in one process for standalone mode
  (parity: nidx_binding, nidx/nidx_binding/src/lib.rs:53-199)
"""

from .indexer import IndexerService
from .scheduler import SchedulerService
from .worker import WorkerService
from .searcher import SyncedSearcher
from .binding import EmbeddedNode

__all__ = [
    "IndexerService",
    "SchedulerService",
    "WorkerService",
    "SyncedSearcher",
    "EmbeddedNode",
]

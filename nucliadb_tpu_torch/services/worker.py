"""Worker service: executes merge jobs.

The port's copy of ``nucliadb_tpu/services/worker.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nidx/src/worker.rs:42-343 — lease a job, download operant segments,
run the per-kind merge applying deletions with seq > segment seq, upload the
merged segment, swap in one metadata transaction.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ..index.json import JsonIndexer
from ..index.paragraph import ParagraphIndexer
from ..index.relation import RelationIndexer
from ..index.text import TextIndexer
from ..index.vector import VectorIndexer
from ..index.vector.config import VectorConfig
from ..metadata import MetadataStore, MergeJob
from ..storage import Storage
from ..storage.storage import download_segment, upload_segment
from ..types import SegmentMetadata, Seq, SimpleOpenIndex


class WorkerService:
    def __init__(self, metadata: MetadataStore, storage: Storage, work_dir: str | None = None):
        self.metadata = metadata
        self.storage = storage
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="ndbtpu_worker_")
        from ..telemetry.metrics import UtilizationTracker

        self.utilization = UtilizationTracker("worker")

    def run_one(self) -> bool:
        """Take and run one merge job; returns False when queue is empty.

        Failed jobs are LEFT LEASED: the lease goes stale, take_merge_job
        re-leases with retries+1 and poison jobs die at the retry cap —
        deleting the job on failure would reset the retry count every
        scheduler tick and re-run a deterministic failure forever.
        """
        job = self.metadata.take_merge_job()
        if job is None:
            return False
        try:
            with self.utilization.work():
                self._run_job(job)
        except Exception:
            import logging

            logging.getLogger(__name__).exception(
                "merge job %s failed (retry %s)", job.id, job.retries
            )
            return True
        self.metadata.finish_merge_job(job.id)
        return True

    def _index_kind_and_config(self, index_id: int):
        index = self.metadata.get_index(index_id)
        if index is None:
            raise KeyError(f"unknown index {index_id}")
        return index

    def _run_job(self, job: MergeJob) -> None:
        import threading

        from ..telemetry.tracing import span as _span

        # heartbeat for the WHOLE job from a side thread: a merge longer
        # than the stale lease window would otherwise let a second worker
        # re-lease the job and commit a duplicate merged segment
        hb_stop = threading.Event()

        def heartbeat():
            while not hb_stop.wait(10.0):
                try:
                    self.metadata.heartbeat_merge_job(job.id)
                except Exception:
                    return

        hb = threading.Thread(target=heartbeat, daemon=True)
        hb.start()
        try:
            with _span("worker.merge_job", job_id=job.id, index_id=job.index_id):
                self._run_job_inner(job)
        finally:
            hb_stop.set()
            hb.join(timeout=1)

    def _run_job_inner(self, job: MergeJob) -> None:
        try:
            index = self._index_kind_and_config(job.index_id)
        except KeyError:
            # the index's shard was deleted between scheduling and execution
            # (rollover retires old shards, delete_kb drops them) — the job
            # is permanently void, not a transient failure; burning retries
            # on it just spams the log (observed in the soak test)
            import logging

            logging.getLogger(__name__).info(
                "merge job %s dropped: index %s no longer exists",
                job.id, job.index_id,
            )
            return
        operants = self.metadata.merge_job_segments(job.id)
        if len(operants) < 2:
            return
        job_dir = os.path.join(self.work_dir, f"job_{job.id}")
        open_index = SimpleOpenIndex(
            deletion_list=self.metadata.deletions_for_index(job.index_id)
        )
        for seg in operants:
            local = os.path.join(job_dir, f"seg_{seg.id}")
            download_segment(self.storage, seg.storage_key, local)
            open_index.segment_list.append(
                (
                    SegmentMetadata(
                        path=local,
                        records=seg.records,
                        tags=frozenset(seg.tags),
                        index_metadata=seg.index_metadata,
                    ),
                    seg.seq,
                )
            )
        self.metadata.heartbeat_merge_job(job.id)

        out_dir = os.path.join(job_dir, "merged")
        merged = self._merge(index.kind, index.configuration, open_index, out_dir)
        self.metadata.heartbeat_merge_job(job.id)

        # merged segment lives at the seq of its newest operant: deletions
        # after that seq still apply to it (parity: worker.rs merge seq rule)
        row = self.metadata.create_segment(
            job.index_id,
            job.seq,
            merged.records,
            tags=sorted(merged.tags),
            index_metadata=merged.index_metadata,
        )
        size = upload_segment(self.storage, row.storage_key, merged.path)
        self.metadata.set_segment_size(row.id, size)
        self.metadata.commit_operation(
            ready_segments=[row.id],
            deletions=[],
            touched_indexes=[job.index_id],
            replaced_segments=[s.id for s in operants],
        )
        shutil.rmtree(job_dir, ignore_errors=True)

    @staticmethod
    def _merge(kind: str, configuration: dict, open_index, out_dir: str) -> SegmentMetadata:
        from ..telemetry.metrics import merge_observer

        with merge_observer({"kind": kind}):
            return WorkerService._merge_inner(kind, configuration, open_index, out_dir)

    @staticmethod
    def _merge_inner(kind: str, configuration: dict, open_index, out_dir: str) -> SegmentMetadata:
        if kind == "vector":
            return VectorIndexer(VectorConfig.from_dict(configuration)).merge(
                open_index, out_dir
            )
        if kind == "text":
            return TextIndexer().merge(open_index, out_dir)
        if kind == "paragraph":
            return ParagraphIndexer().merge(open_index, out_dir)
        if kind == "relation":
            return RelationIndexer().merge(open_index, out_dir)
        if kind == "json":
            return JsonIndexer().merge(open_index, out_dir)
        raise ValueError(f"unknown index kind {kind}")

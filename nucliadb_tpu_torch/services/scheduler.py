"""Scheduler service: merge planning + purge loops.

The port's copy of ``nucliadb_tpu/services/scheduler.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity: nidx/src/scheduler.rs + scheduler/{log_merge,vector_merge}.rs.
Merges are only planned over segments at or below the ack floor (so a merge
never outruns in-flight operations) and never over segments already taken
by another job.

Policies (defaults match nidx/src/settings.rs:228-277):
- log merge (text/paragraph/relation/json): tantivy-style log buckets —
  segments bucketed by log of record count between bottom (10k) and top
  (10M); any bucket with >= 4 segments merges.
- vector merge: small segments (<20k records) merge together into targets
  of <= 200k records; >= 4 small segments trigger a merge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..metadata import MetadataStore, SegmentRow
from ..types import Seq

MIN_SEGMENTS_TO_MERGE = 4
LOG_TOP_RECORDS = 10_000_000
LOG_BOTTOM_RECORDS = 10_000
LOG_BUCKET_BASE = 2.0
VECTOR_SMALL_THRESHOLD = 20_000
VECTOR_MAX_SEGMENT = 200_000


def plan_log_merges(segments: list[SegmentRow]) -> list[list[SegmentRow]]:
    """Group mergeable segments into log buckets (scheduler/log_merge.rs:58-110).

    A bucket splits into chunks whose summed record count stays under the top
    bucket size (the reference's chunking, log_merge.rs:92-107) so one job
    never merges an unbounded number of records.
    """
    buckets: dict[int, list[SegmentRow]] = {}
    for seg in segments:
        if seg.records >= LOG_TOP_RECORDS:
            continue
        level = int(
            math.log(max(seg.records, LOG_BOTTOM_RECORDS) / LOG_BOTTOM_RECORDS)
            / math.log(LOG_BUCKET_BASE)
        )
        buckets.setdefault(level, []).append(seg)
    plans = []
    for level in sorted(buckets):
        group = sorted(buckets[level], key=lambda s: int(s.seq))
        chunk: list[SegmentRow] = []
        total = 0
        for seg in group:
            if total + seg.records > LOG_TOP_RECORDS and chunk:
                if len(chunk) >= MIN_SEGMENTS_TO_MERGE:
                    plans.append(chunk)
                chunk, total = [], 0
            chunk.append(seg)
            total += seg.records
        if len(chunk) >= MIN_SEGMENTS_TO_MERGE:
            plans.append(chunk)
    return plans


def plan_vector_merges(segments: list[SegmentRow]) -> list[list[SegmentRow]]:
    """Small/big partition merge planning (scheduler/vector_merge.rs:27-80).

    Segments are partitioned by tag set first: a hidden-tagged segment never
    merges with a visible one, so the searcher's coarse per-segment tag mask
    stays exact (merging them would union the tags and over-hide the
    visible paragraphs)."""
    plans: list[list[SegmentRow]] = []
    by_tags: dict[frozenset, list[SegmentRow]] = {}
    for s in segments:
        if s.records < VECTOR_SMALL_THRESHOLD:
            by_tags.setdefault(frozenset(s.tags), []).append(s)
    for small in by_tags.values():
        small.sort(key=lambda s: int(s.seq))
        group: list[SegmentRow] = []
        total = 0
        for seg in small:
            if total + seg.records > VECTOR_MAX_SEGMENT and group:
                if len(group) >= MIN_SEGMENTS_TO_MERGE:
                    plans.append(group)
                group, total = [], 0
            group.append(seg)
            total += seg.records
        if len(group) >= MIN_SEGMENTS_TO_MERGE:
            plans.append(group)
    return plans


AUDIT_INTERVAL_S = 3600.0  # KB storage reports are hourly, not per tick


class SchedulerService:
    def __init__(self, metadata: MetadataStore, storage=None, audit=None):
        self.metadata = metadata
        self.storage = storage
        self.audit = audit  # AuditStream (optional)
        self._last_audit = 0.0

    def schedule_merges(self) -> int:
        """Plan merges for every index; returns number of jobs enqueued.

        Parity: MergeScheduler::schedule_merges (scheduler/merge_task.rs) —
        only segments with seq <= ack floor participate.
        """
        floor = self.metadata.ack_floor()
        enqueued = 0
        for shard in self.metadata.list_shards():
            for index in self.metadata.get_indexes(shard.id):
                segments = [
                    s
                    for s in self.metadata.ready_segments(index.id)
                    if s.merge_job_id is None and s.seq <= floor
                ]
                if index.kind == "vector":
                    plans = plan_vector_merges(segments)
                else:
                    plans = plan_log_merges(segments)
                for plan in plans:
                    top_seq = max(int(s.seq) for s in plan)
                    job = self.metadata.enqueue_merge(
                        index.id, Seq(top_seq), [s.id for s in plan]
                    )
                    if job is not None:
                        enqueued += 1
        return enqueued

    def purge_segments(self) -> int:
        """Drop expired segments from storage + metadata
        (parity: scheduler/purge_tasks.rs)."""
        purged = 0
        for seg in self.metadata.purgeable_segments():
            if self.storage is not None:
                self.storage.delete(seg.storage_key)
            self.metadata.drop_segment(seg.id)
            purged += 1
        return purged

    def purge_deletions(self) -> None:
        """Deletions at or below every segment's seq can never apply again —
        bounded ALSO by the ack floor (parity: purge_tasks.rs:47-63): an
        in-flight op below the deletion could still commit a segment the
        deletion must apply to."""
        floor = int(self.metadata.ack_floor())
        for shard in self.metadata.list_shards():
            for index in self.metadata.get_indexes(shard.id):
                segs = self.metadata.ready_segments(index.id)
                if segs:
                    bound = min(min(int(s.seq) for s in segs), floor)
                else:
                    # zero segments: any future segment gets a seq above the
                    # ack floor, so deletions at/below it are dead — without
                    # this, an all-deleted index's deletion list grows with
                    # every delete ever issued
                    bound = floor
                self.metadata.purge_deletions_below(index.id, Seq(bound))

    def audit_storage(self) -> dict[str, dict]:
        """Per-KB storage report to the audit stream (parity: the scheduler
        KB storage audit task, nidx/src/scheduler/audit_task.rs:170 — bytes,
        records and segment counts per knowledge box)."""
        report: dict[str, dict] = {}
        for shard in self.metadata.list_shards():
            agg = report.setdefault(
                shard.kbid, {"bytes": 0, "records": 0, "segments": 0}
            )
            for index in self.metadata.get_indexes(shard.id):
                for seg in self.metadata.ready_segments(index.id):
                    agg["bytes"] += seg.size_bytes
                    agg["records"] += seg.records
                    agg["segments"] += 1
        if self.audit is not None:
            from ..common.audit import AuditType

            for kbid, stats in report.items():
                self.audit.report(
                    kbid=kbid, audit_type=AuditType.STORAGE, detail=stats
                )
        return report

    def tick(self) -> int:
        self.metadata.expire_stale_requests()
        jobs = self.schedule_merges()
        self.purge_segments()
        self.purge_deletions()
        self.metadata.prune_acked_requests(self.metadata.ack_floor())
        import time as _time

        if self.audit is not None and _time.time() - self._last_audit > AUDIT_INTERVAL_S:
            self._last_audit = _time.time()
            self.audit_storage()
        return jobs

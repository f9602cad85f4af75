"""Augmentor: batch hydration/augmentation operations for agent workflows.

The port's copy of ``nucliadb_tpu/search/augmentor.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's augmentor
(nucliadb/src/nucliadb/search/augmentor/augmentor.py:64-156 + /augment API):
one request carries a batch of operations addressing resources, fields or
paragraphs; the response returns the hydrated/augmented blocks. Supported
operations: ``resource`` (title/summary/labels), ``field`` (full extracted
text), ``paragraph`` (text span by paragraph id), ``neighbours`` (adjacent
paragraph spans around a paragraph id).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from pydantic import BaseModel, Field

from ..ingest.brain import split_paragraphs
from ..ingest.processor import Processor


class AugmentOp(BaseModel):
    op: str  # resource | field | paragraph | neighbours
    rid: str = ""
    field_id: str = ""
    paragraph_id: str = ""
    before: int = 1
    after: int = 1


class AugmentRequest(BaseModel):
    operations: list[AugmentOp] = Field(default_factory=list)


class AugmentBlock(BaseModel):
    op: str
    id: str
    text: str = ""
    title: str = ""
    labels: list[str] = Field(default_factory=list)
    error: str = ""


class AugmentResponse(BaseModel):
    blocks: list[AugmentBlock] = Field(default_factory=list)


def _parse_pid(pid: str) -> Optional[tuple[str, str, int, int]]:
    parts = pid.split("/")
    try:
        start, end = parts[-1].split("-")
        return parts[0], "/".join(parts[1:-1]), int(start), int(end)
    except (ValueError, IndexError):
        return None


class Augmentor:
    def __init__(self, processor: Processor):
        self.processor = processor

    def augment(self, kbid: str, request: AugmentRequest) -> AugmentResponse:
        out = AugmentResponse()
        for op in request.operations:
            out.blocks.append(self._one(kbid, op))
        return out

    def _one(self, kbid: str, op: AugmentOp) -> AugmentBlock:
        if op.op == "resource":
            payload = self.processor.get_payload(kbid, op.rid)
            if payload is None:
                return AugmentBlock(op=op.op, id=op.rid, error="not found")
            labels = [
                f"/l/{c.labelset}/{c.label}"
                for c in payload.usermetadata.classifications
            ]
            return AugmentBlock(
                op=op.op, id=op.rid, title=payload.title, text=payload.summary,
                labels=labels,
            )
        if op.op == "field":
            text = self.processor.field_text(kbid, op.rid, op.field_id)
            if text is None:
                return AugmentBlock(op=op.op, id=f"{op.rid}/{op.field_id}", error="not found")
            return AugmentBlock(op=op.op, id=f"{op.rid}/{op.field_id}", text=text)
        if op.op in ("paragraph", "neighbours"):
            parsed = _parse_pid(op.paragraph_id)
            if parsed is None:
                return AugmentBlock(op=op.op, id=op.paragraph_id, error="bad paragraph id")
            rid, fid, start, end = parsed
            text = self.processor.field_text(kbid, rid, fid)
            if text is None:
                return AugmentBlock(op=op.op, id=op.paragraph_id, error="not found")
            if op.op == "paragraph":
                return AugmentBlock(op=op.op, id=op.paragraph_id, text=text[start:end])
            spans = split_paragraphs(text)
            idx = next(
                (i for i, (s, e) in enumerate(spans) if s <= start and end <= e), None
            )
            if idx is None:
                return AugmentBlock(op=op.op, id=op.paragraph_id, text=text[start:end])
            lo = max(0, idx - op.before)
            hi = min(len(spans), idx + op.after + 1)
            joined = "\n\n".join(text[s:e] for s, e in spans[lo:hi])
            return AugmentBlock(op=op.op, id=op.paragraph_id, text=joined)
        return AugmentBlock(op=op.op, id="", error=f"unknown op {op.op!r}")

"""ResourceBrain: build the index message from resource state.

The port's copy of ``nucliadb_tpu/ingest/brain.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's brain builder
(nucliadb/src/nucliadb/ingest/orm/brain_v2.py:76-783 +
index_message.py:44-353): turns stored resource fields into a ResourceDoc —
texts per field, paragraphs with positions, the label hierarchy facets
(docs/internal/SEARCH.md:104-141), vectors per vectorset, relations,
security — plus the deletion prefixes for reindexing.

Label hierarchy emitted (subset matching the reference's conventions):
  /n/s/{status}      resource status
  /n/i/{icon}        resource icon/mimetype
  /l/{set}/{label}   classifications
  /t/{tag}           origin tags
  /u/s/{source_id}   origin source
  /e/{group}/{value} entities (from relations)
"""

from __future__ import annotations

import re
import time
from typing import Optional

import numpy as np

from ..models.api import CreateResourcePayload, user_relations
from ..models.internal import (
    IndexParagraph,
    IndexRelation,
    RelationNode,
    ResourceDoc,
    ResourceStatus,
    Security,
    TextInformation,
    VectorSentence,
    paragraph_id,
    vector_key,
)

PARAGRAPH_SPLIT_RE = re.compile(r"\n\s*\n")


def split_paragraphs(text: str) -> list[tuple[int, int]]:
    """[start, end) character ranges of paragraphs (double-newline blocks).

    The reference receives paragraph boundaries from the processing service;
    an embedded deployment derives them from the text itself.
    """
    if not text.strip():
        return []
    spans = []
    pos = 0
    for m in PARAGRAPH_SPLIT_RE.finditer(text):
        if m.start() > pos:
            spans.append((pos, m.start()))
        pos = m.end()
    if pos < len(text):
        spans.append((pos, len(text)))
    return spans


class ResourceBrain:
    def __init__(self, rid: str):
        self.rid = rid

    def resource_labels(self, payload: CreateResourcePayload, status: ResourceStatus) -> list[str]:
        labels = [f"/n/s/{status.value}"]
        if payload.icon:
            labels.append(f"/n/i/{payload.icon}")
        for c in payload.usermetadata.classifications:
            labels.append(f"/l/{c.labelset}/{c.label}")
        if payload.origin:
            labels.extend(f"/t/{t}" for t in payload.origin.tags)
            if payload.origin.source_id:
                labels.append(f"/u/s/{payload.origin.source_id}")
            # the remaining origin facet hierarchies the rich
            # filter_expression atoms match (facet_from_filter parity,
            # reference common/filter_expression.py:352-403)
            for k, v in payload.origin.metadata.items():
                labels.append(f"/m/{k}/{v}")
            if payload.origin.path:
                labels.append("/p/" + payload.origin.path.strip("/"))
            labels.extend(f"/u/o/{c}" for c in payload.origin.collaborators)
        meta = getattr(payload, "metadata", None)
        if meta is not None:
            if meta.language:
                labels.append(f"/s/p/{meta.language}")
                labels.append(f"/s/s/{meta.language}")
            labels.extend(f"/s/s/{l}" for l in meta.languages)
        for rel in user_relations(payload):
            for node in (rel.from_, rel.to):
                if node is not None and node.type == "entity":
                    labels.append(f"/e/{node.group}/{node.value}")
        if payload.hidden:
            # hidden resources carry LABEL_HIDDEN so every index leg can
            # exclude them with a NOT filter (parity: brain_v2.py:820-822,
            # nucliadb_models/labels.py LABEL_HIDDEN = "/q/h")
            labels.append("/q/h")
        return sorted(set(labels))

    def build(
        self,
        payload: CreateResourcePayload,
        *,
        status: ResourceStatus = ResourceStatus.PROCESSED,
        created: float | None = None,
    ) -> ResourceDoc:
        now = time.time()
        doc = ResourceDoc(
            resource_id=self.rid,
            labels=self.resource_labels(payload, status),
            status=status,
            created=created if created is not None else now,
            modified=now,
        )

        # per-field mimetype facet (/mt — the field_mimetype filter; parity:
        # the reference's FieldComputedMetadata mimetype facet)
        _FORMAT_MT = {
            "PLAIN": "text/plain", "HTML": "text/html",
            "MARKDOWN": "text/markdown", "KEEP_MARKDOWN": "text/markdown",
            "RST": "text/x-rst", "JSON": "application/json",
        }
        fields: dict[str, str] = {}
        field_labels: dict[str, list[str]] = {}
        if payload.title:
            fields["a/title"] = payload.title
        if payload.summary:
            fields["a/summary"] = payload.summary
        for name, tf in payload.texts.items():
            fields[f"t/{name}"] = tf.body
            mt = getattr(tf, "mimetype", "") or _FORMAT_MT.get(tf.format, "")
            if mt:
                field_labels[f"t/{name}"] = [f"/mt/{mt}"]
        # link fields index their stored title/description/uri (u/ prefix,
        # parity: reference link fields — URI content extraction is the
        # processing service's job)
        for name, lf in payload.links.items():
            fields[f"u/{name}"] = "\n".join(
                part for part in (lf.title, lf.description, lf.uri) if part
            )
            field_labels[f"u/{name}"] = ["/mt/text/html"]

        for fid, text in fields.items():
            doc.texts[fid] = TextInformation(
                text=text, labels=field_labels.get(fid, [])
            )
            # paragraph kind facet (/k — the Kind paragraph filter; title
            # paragraphs are TITLE, the rest TEXT; richer kinds — OCR,
            # TABLE, TRANSCRIPT — come from an external processing engine)
            kind = "/k/title" if fid == "a/title" else "/k/text"
            paragraphs: dict[str, IndexParagraph] = {}
            for start, end in split_paragraphs(text):
                pid = paragraph_id(self.rid, fid, start, end)
                paragraphs[pid] = IndexParagraph(
                    start=start, end=end, fieldname=fid, index=len(paragraphs),
                    labels=[kind],
                )
            if paragraphs:
                doc.paragraphs[fid] = paragraphs

        # conversation fields: one paragraph per message with exact offsets
        # into the joined transcript (c/ prefix, parity: conversation fields
        # indexing each message as a paragraph)
        for name, conv in payload.conversations.items():
            fid = f"c/{name}"
            spans: list[tuple[int, int]] = []
            pos = 0
            lines = conv.transcript_lines()
            for line in lines:
                spans.append((pos, pos + len(line)))
                pos += len(line) + 1  # joining newline
            text = "\n".join(lines)
            if not text:
                continue
            doc.texts[fid] = TextInformation(text=text, labels=[])
            paragraphs = {}
            for (start, end), msg in zip(spans, conv.messages):
                pid = paragraph_id(self.rid, fid, start, end)
                paragraphs[pid] = IndexParagraph(
                    start=start, end=end, fieldname=fid, index=len(paragraphs),
                    # split = message ident (parity: conversation splits —
                    # ExtractedTexts serves per-split text by slicing the
                    # transcript at this paragraph's offsets)
                    split=msg.ident or str(len(paragraphs)),
                )
            doc.paragraphs[fid] = paragraphs

        # attach sentence embeddings to their containing paragraphs
        for vectorset, by_field in payload.embeddings.items():
            for api_field, sentences in by_field.items():
                fid = api_field if "/" in api_field else f"t/{api_field}"
                paragraphs = doc.paragraphs.get(fid)
                if paragraphs is None:
                    continue
                for idx, emb in enumerate(sentences):
                    target: Optional[IndexParagraph] = None
                    for para in paragraphs.values():
                        if emb.start >= para.start and emb.end <= para.end:
                            target = para
                            break
                    if target is None:  # fall back to first paragraph
                        target = next(iter(paragraphs.values()))
                    key = vector_key(self.rid, fid, idx, emb.start, emb.end)
                    target.vectorsets_sentences.setdefault(vectorset, {})[key] = (
                        VectorSentence(vector=np.asarray(emb.vector, np.float32))
                    )

        # relations — user relations carry the /g/u generator facet,
        # data-augmentation relations /g/da/<task>, plain processor
        # relations no /g facet (parity: brain_v2.py:454-461, 766-769)
        rels: list[IndexRelation] = []

        def _rel(rel, facets: list[str]) -> Optional[IndexRelation]:
            if rel.from_ is None or rel.to is None:
                return None
            return IndexRelation(
                source=RelationNode(
                    value=rel.from_.value,
                    ntype=rel.from_.type.upper(),
                    subtype=rel.from_.group,
                ),
                target=RelationNode(
                    value=rel.to.value, ntype=rel.to.type.upper(), subtype=rel.to.group
                ),
                relation=rel.relation,
                label=rel.label,
                facets=facets,
            )

        for rel in user_relations(payload):
            ir = _rel(rel, ["/g/u"])
            if ir is not None:
                rels.append(ir)
        for rel in getattr(payload, "computed_relations", []):
            task = getattr(rel, "data_augmentation_task_id", None)
            ir = _rel(rel, [f"/g/da/{task}"] if task else [])
            if ir is not None:
                if task:
                    ir.metadata = {"data_augmentation_task_id": task}
                rels.append(ir)
        if rels:
            doc.relations["a/metadata"] = rels

        if payload.origin and payload.origin.metadata:
            import json

            doc.json_fields["a/origin"] = json.dumps(payload.origin.metadata)
        if payload.key_values:
            import json

            for name, value in payload.key_values.items():
                doc.json_fields[f"kv/{name}"] = json.dumps(value)

        if payload.security is not None:
            doc.security = Security(access_groups=list(payload.security.access_groups))

        # every (re)index op deletes the resource's previous keys: deletions
        # recorded at the op's own seq never touch the op's own segment
        # (strictly-greater rule), so this is safe on first writes too and
        # makes reindexing correct by construction.
        doc.paragraphs_to_delete = [self.rid + "/"]
        doc.vectors_to_delete_in_all_vectorsets = [self.rid + "/"]

        return doc

"""Training batch generators.

The port's copy of ``nucliadb_tpu/train/generators.py``,
kept verbatim: the port imports nothing of the JAX package.

Each generator mirrors one of the reference's train/generators/*.py task
types, streaming fixed-size batches over a KB's resources:

- paragraph classification: (paragraph text, labels) — from classifications
- field classification: (field text, labels)
- sentence streaming: raw paragraph/sentence text per field
- token classification: (tokens, BIO tags) from entity relation values
- question answering: (question=title, answer paragraphs)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, Optional

from ..ingest.brain import split_paragraphs
from ..ingest.processor import Processor
from ..models.api import user_relations
from ..index.text_engine.tokenizer import tokenize


@dataclass
class TrainSet:
    kbid: str
    batch_size: int = 32
    labelset: Optional[str] = None  # restrict classification labels to one set
    seed: int = 0


@dataclass
class ParagraphClassificationBatch:
    texts: list[str] = field(default_factory=list)
    labels: list[list[str]] = field(default_factory=list)


@dataclass
class FieldClassificationBatch:
    texts: list[str] = field(default_factory=list)
    labels: list[list[str]] = field(default_factory=list)


@dataclass
class SentenceBatch:
    rids: list[str] = field(default_factory=list)
    fields: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)


@dataclass
class TokenClassificationBatch:
    tokens: list[list[str]] = field(default_factory=list)
    tags: list[list[str]] = field(default_factory=list)


@dataclass
class QABatch:
    questions: list[str] = field(default_factory=list)
    answers: list[str] = field(default_factory=list)
    rids: list[str] = field(default_factory=list)


def _iter_fields(processor: Processor, kbid: str) -> Iterator[tuple[str, str, str, object]]:
    for rid in processor.list_resources(kbid):
        payload = processor.get_payload(kbid, rid)
        if payload is None:
            continue
        fields = {}
        if payload.title:
            fields["a/title"] = payload.title
        if payload.summary:
            fields["a/summary"] = payload.summary
        for name, tf in payload.texts.items():
            fields[f"t/{name}"] = tf.body
        for fid, text in fields.items():
            yield rid, fid, text, payload


def _labels(payload, labelset: Optional[str]) -> list[str]:
    out = []
    for c in payload.usermetadata.classifications:
        if labelset is None or c.labelset == labelset:
            out.append(f"/l/{c.labelset}/{c.label}")
    return out


def paragraph_classification_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[ParagraphClassificationBatch]:
    batch = ParagraphClassificationBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        labels = _labels(payload, trainset.labelset)
        if not labels:
            continue
        for start, end in split_paragraphs(text):
            batch.texts.append(text[start:end])
            batch.labels.append(labels)
            if len(batch.texts) >= trainset.batch_size:
                yield batch
                batch = ParagraphClassificationBatch()
    if batch.texts:
        yield batch


def field_classification_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[FieldClassificationBatch]:
    batch = FieldClassificationBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        labels = _labels(payload, trainset.labelset)
        if not labels:
            continue
        batch.texts.append(text)
        batch.labels.append(labels)
        if len(batch.texts) >= trainset.batch_size:
            yield batch
            batch = FieldClassificationBatch()
    if batch.texts:
        yield batch


def sentence_batches(processor: Processor, trainset: TrainSet) -> Iterator[SentenceBatch]:
    batch = SentenceBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        for start, end in split_paragraphs(text):
            batch.rids.append(rid)
            batch.fields.append(fid)
            batch.texts.append(text[start:end])
            if len(batch.texts) >= trainset.batch_size:
                yield batch
                batch = SentenceBatch()
    if batch.texts:
        yield batch


def token_classification_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[TokenClassificationBatch]:
    """BIO tagging from entity values present in the text."""
    batch = TokenClassificationBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        entities: dict[str, str] = {}
        for rel in user_relations(payload):
            for node in (rel.from_, rel.to):
                if node is not None and node.type == "entity":
                    entities[node.value.lower()] = node.group or "ENTITY"
        if not entities:
            continue
        tokens = tokenize(text)
        tags = ["O"] * len(tokens)
        for value, group in entities.items():
            etoks = tokenize(value)
            if not etoks:
                continue
            for i in range(len(tokens) - len(etoks) + 1):
                if tokens[i : i + len(etoks)] == etoks:
                    tags[i] = f"B-{group}"
                    for j in range(1, len(etoks)):
                        tags[i + j] = f"I-{group}"
        batch.tokens.append(tokens)
        batch.tags.append(tags)
        if len(batch.tokens) >= trainset.batch_size:
            yield batch
            batch = TokenClassificationBatch()
    if batch.tokens:
        yield batch


def qa_batches(processor: Processor, trainset: TrainSet) -> Iterator[QABatch]:
    """(title as question, body paragraphs as answers) pairs."""
    batch = QABatch()
    for rid in processor.list_resources(trainset.kbid):
        payload = processor.get_payload(trainset.kbid, rid)
        if payload is None or not payload.title:
            continue
        for name, tf in payload.texts.items():
            for start, end in split_paragraphs(tf.body):
                batch.questions.append(payload.title)
                batch.answers.append(tf.body[start:end])
                batch.rids.append(rid)
                if len(batch.questions) >= trainset.batch_size:
                    yield batch
                    batch = QABatch()
    if batch.questions:
        yield batch


@dataclass
class SentenceClassificationBatch:
    texts: list[str] = field(default_factory=list)
    labels: list[list[str]] = field(default_factory=list)


@dataclass
class FieldStreamingBatch:
    rids: list[str] = field(default_factory=list)
    fields: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)
    labels: list[list[str]] = field(default_factory=list)


@dataclass
class ParagraphStreamingBatch:
    paragraph_ids: list[str] = field(default_factory=list)
    texts: list[str] = field(default_factory=list)


@dataclass
class ImageClassificationBatch:
    rids: list[str] = field(default_factory=list)
    fields: list[str] = field(default_factory=list)
    blob_keys: list[str] = field(default_factory=list)
    content_types: list[str] = field(default_factory=list)
    labels: list[list[str]] = field(default_factory=list)


_SENTENCE_RE = re.compile(r"[^.!?\n]+[.!?]?")


def sentence_classification_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[SentenceClassificationBatch]:
    """(sentence, labels) pairs (parity: train/generators/
    sentence_classifier.py)."""
    batch = SentenceClassificationBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        labels = _labels(payload, trainset.labelset)
        if not labels:
            continue
        for start, end in split_paragraphs(text):
            for m in _SENTENCE_RE.finditer(text[start:end]):
                sent = m.group(0).strip()
                if sent:
                    batch.texts.append(sent)
                    batch.labels.append(labels)
                    if len(batch.texts) >= trainset.batch_size:
                        yield batch
                        batch = SentenceClassificationBatch()
    if batch.texts:
        yield batch


def field_streaming_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[FieldStreamingBatch]:
    """Full field text + labels stream (parity: field_streaming.py)."""
    batch = FieldStreamingBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        batch.rids.append(rid)
        batch.fields.append(fid)
        batch.texts.append(text)
        batch.labels.append(_labels(payload, trainset.labelset))
        if len(batch.texts) >= trainset.batch_size:
            yield batch
            batch = FieldStreamingBatch()
    if batch.texts:
        yield batch


def paragraph_streaming_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[ParagraphStreamingBatch]:
    """(paragraph id, text) stream (parity: paragraph_streaming.py)."""
    batch = ParagraphStreamingBatch()
    for rid, fid, text, payload in _iter_fields(processor, trainset.kbid):
        for start, end in split_paragraphs(text):
            batch.paragraph_ids.append(f"{rid}/{fid}/{start}-{end}")
            batch.texts.append(text[start:end])
            if len(batch.texts) >= trainset.batch_size:
                yield batch
                batch = ParagraphStreamingBatch()
    if batch.texts:
        yield batch


def image_classification_batches(
    processor: Processor, trainset: TrainSet
) -> Iterator[ImageClassificationBatch]:
    """Image file fields + resource labels (parity: image_classifier.py —
    the reference streams page selections from image fields; here every
    image/* blob field is an example, addressed by its storage key)."""
    import json as _json

    batch = ImageClassificationBatch()
    kbid = trainset.kbid
    for rid in processor.list_resources(kbid):
        payload = processor.get_payload(kbid, rid)
        if payload is None:
            continue
        labels = _labels(payload, trainset.labelset)
        prefix = f"/kbs/{kbid}/r/{rid}/files/"
        with processor.driver as txn:
            entries = {
                key[len(prefix):]: _json.loads(txn.get(key) or b"{}")
                for key in txn.keys(prefix)
            }
        for fid, info in entries.items():
            if not str(info.get("content_type", "")).startswith("image/"):
                continue
            batch.rids.append(rid)
            batch.fields.append(fid)
            batch.blob_keys.append(info.get("key", ""))
            batch.content_types.append(info["content_type"])
            batch.labels.append(labels)
            if len(batch.rids) >= trainset.batch_size:
                yield batch
                batch = ImageClassificationBatch()
    if batch.rids:
        yield batch

"""Dataset export: persist train batches to disk partitions.

The port's copy of ``nucliadb_tpu/train/dataset.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's nucliadb_dataset package
(nucliadb_dataset/src/nucliadb_dataset/dataset.py — export of Train gRPC
streams to one Arrow IPC file per partition plus a manifest): partitions
are Arrow streaming-format files with a schema derived from the task's
batch type, so any Arrow/HuggingFace loader consumes them directly. A
msgpack format is kept as a dependency-free fallback (``format="msgpack"``).

The WRITE path uses the repo's pure-Python Arrow IPC writer
(train/arrow_ipc.py) — pyarrow's write machinery segfaulted rarely under
this process's thread/allocator mix (see arrow_ipc.py for the forensic
trail). pyarrow remains the READ path (load_partition), which doubles as
a continuous two-implementation differential check of the emitted bytes.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Callable, Iterator

import msgpack

from ..ingest.processor import Processor
from . import arrow_ipc
from .generators import TrainSet

GENERATORS: dict[str, Callable] = {}
BATCH_CLASSES: dict[str, type] = {}


def _register():
    from . import generators as g

    GENERATORS.update(
        {
            "paragraph_classification": g.paragraph_classification_batches,
            "field_classification": g.field_classification_batches,
            "sentences": g.sentence_batches,
            "token_classification": g.token_classification_batches,
            "question_answers": g.qa_batches,
            "sentence_classification": g.sentence_classification_batches,
            "field_streaming": g.field_streaming_batches,
            "paragraph_streaming": g.paragraph_streaming_batches,
            "image_classification": g.image_classification_batches,
        }
    )
    BATCH_CLASSES.update(
        {
            "paragraph_classification": g.ParagraphClassificationBatch,
            "field_classification": g.FieldClassificationBatch,
            "sentences": g.SentenceBatch,
            "token_classification": g.TokenClassificationBatch,
            "question_answers": g.QABatch,
            "sentence_classification": g.SentenceClassificationBatch,
            "field_streaming": g.FieldStreamingBatch,
            "paragraph_streaming": g.ParagraphStreamingBatch,
            "image_classification": g.ImageClassificationBatch,
        }
    )


_register()


def _fields_for(columns: dict) -> list:
    return [(name, arrow_ipc.infer_type(col)) for name, col in columns.items()]


def _fields_for_class(cls: type) -> list:
    """Schema from the batch dataclass annotations (needed when zero
    batches were produced and there is no sample value to infer from).
    Columns are list[T]: strip one list level, then map nesting to Arrow
    List depth (str -> Utf8, list[str] -> List(Utf8), ...)."""
    import typing

    fields = []
    for name, hint in typing.get_type_hints(cls).items():
        depth = -1  # the column list itself doesn't count
        while typing.get_origin(hint) is list:
            depth += 1
            hint = typing.get_args(hint)[0]
        t: object = arrow_ipc.Utf8()
        for _ in range(max(depth, 0)):
            t = arrow_ipc.List(t)
        fields.append((name, t))
    return fields


def export_trainset(
    processor: Processor,
    trainset: TrainSet,
    task: str,
    output_dir: str,
    *,
    batches_per_partition: int = 64,
    format: str = "arrow",
) -> dict:
    """Write partition files + manifest; returns the manifest.

    ``format="arrow"`` (default) writes Arrow IPC streaming files — the
    reference dataset layout; ``format="msgpack"`` writes msgpack lists.
    """
    if task not in GENERATORS:
        raise ValueError(f"unknown train task {task!r}; options: {sorted(GENERATORS)}")
    if format not in ("arrow", "msgpack"):
        raise ValueError(f"unknown format {format!r}")
    os.makedirs(output_dir, exist_ok=True)
    generator = GENERATORS[task](processor, trainset)
    partitions: list[str] = []
    current: list[dict] = []
    examples = 0

    def flush():
        nonlocal current
        if not current:
            return
        if format == "arrow":
            name = f"part-{len(partitions):05d}.arrow"
            with open(os.path.join(output_dir, name), "wb") as sink:
                arrow_ipc.write_stream(sink, _fields_for(current[0]), current)
        else:
            name = f"part-{len(partitions):05d}.msgpack"
            with open(os.path.join(output_dir, name), "wb") as f:
                f.write(msgpack.packb(current))
        partitions.append(name)
        current = []

    for batch in generator:
        d = asdict(batch)
        examples += len(next(iter(d.values())))
        current.append(d)
        if len(current) >= batches_per_partition:
            flush()
    flush()
    manifest = {
        "kbid": trainset.kbid,
        "task": task,
        "batch_size": trainset.batch_size,
        "format": format,
        "partitions": partitions,
        "examples": examples,
    }
    with open(os.path.join(output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def stream_trainset(
    processor: Processor, trainset: TrainSet, task: str
) -> Iterator[bytes]:
    """Yield one Arrow IPC stream (schema message + record batches) as byte
    chunks — the HTTP body of the reference's train-data endpoint
    (nucliadb/src/nucliadb/train/api/v1/shards.py object_get_response
    streams generate_train_data as application/octet-stream)."""
    if task not in GENERATORS:
        raise ValueError(f"unknown train task {task!r}; options: {sorted(GENERATORS)}")
    fields = None
    for batch in GENERATORS[task](processor, trainset):
        d = asdict(batch)
        if fields is None:
            fields = _fields_for(d)
            yield arrow_ipc.schema_message(fields)
        yield arrow_ipc.record_batch_message([(d[name], t) for name, t in fields])
    if fields is None:
        # zero batches: still a VALID (empty) stream — schema + EOS, or
        # pyarrow raises 'stream is empty' on the client
        yield arrow_ipc.schema_message(_fields_for_class(BATCH_CLASSES[task]))
    yield arrow_ipc.EOS


def load_partition(path: str) -> list[dict]:
    """Read one partition back as a list of column-dict batches (both
    formats). Arrow partitions are parsed by PYARROW — an independent
    implementation validating every byte the writer emitted."""
    if path.endswith(".arrow"):
        import pyarrow as pa

        out = []
        with pa.OSFile(path, "rb") as source:
            with pa.ipc.open_stream(source) as reader:
                for rb in reader:
                    out.append({name: rb.column(i).to_pylist() for i, name in enumerate(rb.schema.names)})
        return out
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())

"""Train service: stream training batches from a knowledge box.

The port's copy of ``nucliadb_tpu/train/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's train component
(nucliadb/src/nucliadb/train/servicer.py:47-110 + train/generators/*.py):
typed generators stream labeled examples assembled from index + KV state —
paragraph/field classification (labels), sentence streaming, token
classification (entities), question-answer pairs — partitioned by shard.
The reference serves them over gRPC; embedded deployments iterate the
generators directly and the dataset module (dataset.py) exports partitions
to disk (the nucliadb_dataset role).
"""

from .generators import (
    FieldClassificationBatch,
    ParagraphClassificationBatch,
    QABatch,
    SentenceBatch,
    TokenClassificationBatch,
    TrainSet,
    field_classification_batches,
    paragraph_classification_batches,
    qa_batches,
    sentence_batches,
    token_classification_batches,
)
from .dataset import export_trainset

__all__ = [
    "TrainSet",
    "ParagraphClassificationBatch",
    "FieldClassificationBatch",
    "SentenceBatch",
    "TokenClassificationBatch",
    "QABatch",
    "paragraph_classification_batches",
    "field_classification_batches",
    "sentence_batches",
    "token_classification_batches",
    "qa_batches",
    "export_trainset",
]

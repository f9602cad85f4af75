"""nucliadb_tpu_torch — the PyTorch / CUDA port of nucliadb_tpu's device cone.

The JAX package (``nucliadb_tpu``) stays the reference. This package holds
its counterparts module by module, under the same names:

- ``utils/platform.py`` — precision policy (no TF32), explicit devices, a
  CUDA stream per dispatching thread and ``device_fetch``, which waits for
  that stream only;
- ``utils/kernels.py``  — builds the hand-written CUDA kernels in ``csrc/``
  with ``nvcc`` at first use and loads them with ``ctypes``;
- ``ops/``              — top-k, exact distances, int8 and binary codes,
  the slot scans (``csrc/int8_slot_scan.cu``,
  ``csrc/binary_slot_scan.cu``), each beside its plain version, and the
  BM25 group program (``ops/bm25.py``, torch ops);
- ``index/vector/``     — segment files, the device-resident vector index
  and the ``VectorSearcher`` facade;
- ``index/text_engine/``, ``index/paragraph/``, ``index/text/`` — the
  keyword leg: text segment files, ``DeviceTextEngine`` with its host WAND
  tier and coalescer, ``ParagraphSearcher`` and ``TextSearcher``.
- ``shard/``, ``services/`` — the index node: ``ShardSearcher`` (the
  prefilters and every leg of one shard request) and ``EmbeddedNode`` with
  ``SyncedSearcher``, over copies of the JAX package's indexer, scheduler,
  worker, JSON and relation indexes, storage, sqlite metadata, telemetry,
  bus and audit modules.
- ``search/``, ``common/kb.py``, ``ingest/``, ``maindb/``, ``models/api.py``
  — the product layer in process: ``SearchService`` (find, retrieve,
  suggest, catalog, graph, ask), ``KnowledgeBoxManager`` and the
  ``Processor`` over the sqlite key-value store, copies of the JAX
  package's, on top of the ported ``EmbeddedNode``.

It imports ``torch``, never ``jax`` and nothing of the JAX package, not
even its jax-free modules. The host modules it needs are copies kept
verbatim: ``types.py``, ``query_language.py``, ``utils/keys.py``,
``utils/buckets.py`` and ``models/internal.py``, beside the copies of the
vector and text segment modules, which read and write the same segment
files, and of the node's host modules, which read and write the same
metadata and blobs. Being copies, their classes and enums are not the JAX package's: a
``LabelAtom`` or ``PrefilterResult`` of one package is not one of the
other (``evaluate_bitset`` dispatches on ``isinstance``; ``IndexKind``,
``PrefilterKind`` and ``ResourceStatus`` compare by identity), so callers
build the port's inputs from the port's types.

The C++ host library ``nucliadb_tpu_native`` (built from ``native/*.cpp``)
is a top-level extension module, not part of the JAX package, and both
packages share it: the port's tokenizer, builder, phrase matcher and host
WAND tier call it.
"""

__version__ = "0.1.0"

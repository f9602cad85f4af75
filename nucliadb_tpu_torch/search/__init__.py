"""Search product layer: /find pipeline, rank fusion, suggest, catalog, ask.

The port's copy of ``nucliadb_tpu/search/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's search service
(nucliadb/src/nucliadb/search/): query parsing, shard fan-out, rank fusion
(RRF k=60), text hydration and response building (find_merge.py), plus the
auxiliary endpoints. The retrieval itself runs in the index node (device
kernels); this layer orchestrates and shapes responses.
"""

from .find import SearchService

__all__ = ["SearchService"]

"""Main KV database: the product layer's source of truth.

The port's copy of ``nucliadb_tpu/maindb/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's maindb driver
(nucliadb/src/nucliadb/common/maindb/driver.py:31-94 + pg.py:79-156): an
ordered KV store with transactions, get/set/delete and prefix scans, keyed
with the layout documented in the reference's docs/internal/KV.md
(``/kbs/{kbid}/...``). Backend: sqlite (a PG driver can slot in unchanged).
"""

from .driver import Driver, Transaction

__all__ = ["Driver", "Transaction"]

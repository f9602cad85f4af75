"""Standalone mode: the whole stack in one process behind one HTTP API.

Parity with the reference's standalone binary
(nucliadb/src/nucliadb/standalone/run.py:84-147): writer + reader + search
APIs mounted together over an embedded index node (the nidx-binding
analogue, services/binding.py) with local storage and sqlite metadata/KV.

Counterpart of ``nucliadb_tpu/standalone``: the app runs the port's node on
a torch device (``StandaloneApp(..., device="cuda")``, the default).
"""

from .app import StandaloneApp

__all__ = ["StandaloneApp"]

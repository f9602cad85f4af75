"""HTTP client SDK.

The port's copy of ``nucliadb_tpu/sdk/__init__.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's nucliadb_sdk package: a thin typed client over
the v1 REST API (httpx), returning the same pydantic models the server
uses.
"""

from .client import NucliaDBClient

__all__ = ["NucliaDBClient"]

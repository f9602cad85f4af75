"""The port's copy of ``nucliadb_tpu/version.py``,
kept verbatim: the port imports nothing of the JAX package."""

__version__ = "0.1.0"

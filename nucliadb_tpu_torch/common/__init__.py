"""Cross-cutting components. The port holds ``audit.py`` only, a copy of
``nucliadb_tpu/common/audit.py`` (the scheduler's storage audit reaches it).
"""

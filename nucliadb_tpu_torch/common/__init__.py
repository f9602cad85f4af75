"""Cross-cutting product components: KB/cluster management, locking, the
KB vocabulary services, the external-index hook and audit. The modules are
copies of the JAX package's ``nucliadb_tpu/common/`` modules of the same
names.
"""

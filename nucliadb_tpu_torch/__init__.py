"""nucliadb_tpu_torch — the PyTorch / CUDA port of nucliadb_tpu's device cone.

The JAX package (``nucliadb_tpu``) stays the reference. This package holds
its counterparts module by module, under the same names:

- ``utils/platform.py`` — precision policy (no TF32), explicit devices and
  ``device_fetch``;
- ``utils/kernels.py``  — builds the hand-written CUDA kernels in ``csrc/``
  with ``nvcc`` at first use and loads them with ``ctypes``;
- ``ops/``              — top-k, exact distances, int8 codes and the
  top-2 slot scan (``csrc/int8_slot_scan.cu``);
- ``index/vector/``     — segment files, the device-resident vector index
  and the ``VectorSearcher`` facade.

It imports ``torch`` and never ``jax``. The jax-free host modules of the
reference (``nucliadb_tpu.types``, ``query_language``, ``utils.keys``,
``utils.buckets``) are imported as they are; everything under
``nucliadb_tpu.index.vector`` imports jax, so its counterparts here are
copies that read and write the same segment files.
"""

__version__ = "0.1.0"

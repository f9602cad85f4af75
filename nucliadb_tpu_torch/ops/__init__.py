"""Device compute for the vector index, in PyTorch.

Counterparts of ``nucliadb_tpu/ops``:

- ``topk``      — masked top-k with ``lax.top_k``'s tie order, the repeat-id
  mask;
- ``distance``  — exact scans and the exact rerank in full float32;
- ``quant``     — int8 codes and their plain estimate scan;
- ``slot_scan`` — the top-2-per-slot int8 scan: a CUDA kernel
  (``csrc/int8_slot_scan.cu``) beside its plain PyTorch version.
"""

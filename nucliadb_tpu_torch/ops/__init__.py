"""Device compute for the vector and text indexes, in PyTorch.

Counterparts of ``nucliadb_tpu/ops``:

- ``topk``      — ``lax.top_k``'s order (``top_k``), masked top-k, the
  repeat-id mask;
- ``distance``  — exact scans and the exact rerank in full float32;
- ``quant``     — int8 and binary (sign) codes, their plain estimate scans
  and candidate selection;
- ``slot_scan`` — the top-1 and top-2-per-slot int8 scans: one CUDA kernel
  (``csrc/int8_slot_scan.cu``, two modes) beside its plain PyTorch versions;
- ``binary_scan`` — the top-1-per-slot popcount scan of binary codes: a
  CUDA kernel (``csrc/binary_slot_scan.cu``) beside its plain version;
- ``bm25``      — the keyword leg's BM25 group program (tier gather,
  scatter, dense columns, cut) as torch ops;
- ``hnsw``      — the proximity graph's wave build (the host links through
  ``nucliadb_tpu_native``) and its masked adaptive beam search;
- ``ivf``       — k-means and the blocked int8 probe scan.
"""

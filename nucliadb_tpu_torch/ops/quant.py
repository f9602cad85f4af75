"""Int8 symmetric codes and their plain estimate scan.

Counterpart of the int8 half of ``nucliadb_tpu/ops/quant.py``. The binary
(sign-code) half is not ported yet (see ROADMAP.md).

Codes are bit-identical to the JAX package's: the same f32 operations as its
compiled program, and ``torch.round`` rounds half to even as ``jnp.round``
does.

``torch.matmul`` has no int8 path on CUDA, so the exact i32 dot of two code
matrices runs as f32 products over blocks of at most ``INT8_DOT_BLOCK``
dimensions. Every partial sum of a block is an integer of magnitude at most
``INT8_DOT_BLOCK * 128**2 = 2**24``, which f32 represents exactly, in any
summation order, provided TF32 is off (``utils/platform.py``). Block results
are then added in int32.

Candidate selection off the kernel route is an exact top-c with the lower
index first on ties; the JAX package uses ``lax.approx_max_k`` there, which
on the CPU is the same exact top-c.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import platform  # noqa: F401  (applies the precision policy)
from .topk import masked_topk

INT8_RERANK_FACTOR = 4  # int8 estimates are ~1% accurate; small budget suffices
RERANKING_LIMIT = 2000  # hard cap (parity: rabitq.rs:36)

_INV_127 = float(np.float32(1.0 / 127.0))

INT8_DOT_BLOCK = 1024
assert INT8_DOT_BLOCK * 128 * 128 <= 2**24  # f32 holds every partial sum exactly


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact [B, D] x [N, D] int8 dot -> [B, N] int32 (see module docstring)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("int8_dot is exact only with TF32 off")
    out = None
    for d0 in range(0, a.shape[1], INT8_DOT_BLOCK):
        part = a[:, d0 : d0 + INT8_DOT_BLOCK].float() @ b[:, d0 : d0 + INT8_DOT_BLOCK].float().T
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


@dataclass
class Int8Codes:
    """Symmetric int8 quantization: codes [N, D] int8, scale [N] f32."""

    codes: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def encode(vectors: torch.Tensor) -> "Int8Codes":
        codes, scale = quantize_rows(vectors)
        return Int8Codes(codes=codes, scale=scale)


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes and scales (``Int8Codes.encode`` and the
    query quantisation of ``device.py:934-935`` in the JAX package)."""
    v = v.float()
    # XLA rewrites the JAX package's `/ 127.0` into a product with the f32
    # constant 1/127, so that is the arithmetic that gives its scales
    s = v.abs().amax(dim=-1).clamp_min(1e-12) * _INV_127
    codes = torch.round(v / s[:, None]).clamp(-127, 127).to(torch.int8)
    return codes, s


def int8_estimate_scores(ic: Int8Codes, queries: torch.Tensor) -> torch.Tensor:
    """[B, N] approximate dots from the int8 codes."""
    qc, qs = quantize_rows(queries)
    raw = int8_dot(qc, ic.codes).float()
    return raw * qs[:, None] * ic.scale[None, :]


def int8_rerank_budget(k: int) -> int:
    return min(INT8_RERANK_FACTOR * k, RERANKING_LIMIT)


def int8_scan_candidates(
    ic: Int8Codes,
    queries: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, C] candidate estimates, [B, C] candidate ids), C = rerank budget."""
    est = int8_estimate_scores(ic, queries)
    c = min(int8_rerank_budget(k), est.shape[-1])
    return masked_topk(est, c, mask=mask)

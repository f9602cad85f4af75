"""Quantized vector scans: 1-bit sign codes (popcount dot) and int8 codes.

Counterpart of ``nucliadb_tpu/ops/quant.py``, both halves.

Int8 codes are bit-identical to the JAX package's: the same f32 operations
as its compiled program, and ``torch.round`` rounds half to even as
``jnp.round`` does.

Binary codes (``BinaryCodes``): the packed sign bits, the planes of a query
and their popcount dot are bit-identical to the JAX package's. Words are
held as int32 bit patterns (torch has little uint32 support); ``popcount``
is a SWAR count, since torch has no popcount op. The f32 scalars follow
XLA's compiled arithmetic (``mean`` is ``sum * f32(1/D)``, a division by a
constant is a product with its f32 reciprocal, ``x ** 2`` is ``x * x``),
but sums run in another order and XLA contracts ``a * b + c`` into an FMA
on the CPU, so they agree within a few ulps, not bit for bit.

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

EPSILON = 1.9  # error-bound multiplier (parity: rabitq.rs:30)
BINARY_RERANK_FACTOR = 100  # candidates = factor * top_k (parity: rabitq.rs:33)
INT8_RERANK_FACTOR = 4  # int8 estimates are ~1% accurate; small budget suffices
RERANKING_LIMIT = 2000  # hard cap (parity: rabitq.rs:36)
QUERY_BITS = 4  # query quantization bits (parity: rabitq.rs bit planes)


def f32_reciprocal(x: float) -> float:
    """The f32 constant XLA multiplies by where the JAX package divides by
    the constant ``x``."""
    return float(np.float32(1) / np.float32(x))


_INV_127 = float(np.float32(1.0 / 127.0))
_INV_LEVELS = f32_reciprocal((1 << QUERY_BITS) - 1)
INV_12 = f32_reciprocal(12)
_ENCODE_ROWS = 65536  # rows per step of BinaryCodes.encode
_SCAN_ELEMS = 1 << 24  # [B, columns] elements per step of binary_scan_candidates

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


# --------------------------------------------------------------------------
# Binary (1-bit sign) codes
# --------------------------------------------------------------------------


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a [..., D] {0,1} tensor into [..., D/32] words (little-endian
    bits): the JAX package's uint32 words as int32 bit patterns."""
    *lead, d = bits.shape
    assert d % 32 == 0, f"dim {d} must be a multiple of 32 for binary codes"
    b = bits.to(torch.int64).reshape(*lead, d // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """One bits of each int32 bit pattern (a SWAR count on the low 31 bits,
    which never overflows int32, plus the sign bit)."""
    low = x & 0x7FFFFFFF
    low = low - ((low >> 1) & 0x55555555)
    low = (low & 0x33333333) + ((low >> 2) & 0x33333333)
    low = (low + (low >> 4)) & 0x0F0F0F0F
    low = low + (low >> 8)
    low = (low + (low >> 16)) & 0x3F
    return low + (x < 0).to(torch.int32)


@dataclass
class BinaryCodes:
    """Per-vector binary codes and decomposition scalars.

    codes_t: [D/32, N] int32 — packed sign bits, TRANSPOSED (the JAX
             package's uint32 words as bit patterns).
    scale:   [N] f32 — s = mean(|v|), the L2-optimal rank-1 sign scale.
    resid:   [N] f32 — ||v - s*sign(v)||.
    popcnt:  [N] f32 — number of 1-bits (positive dims) per code.
    dim:     D.
    """

    codes_t: torch.Tensor
    scale: torch.Tensor
    resid: torch.Tensor
    popcnt: torch.Tensor
    dim: int

    @property
    def n_vectors(self) -> int:
        return self.codes_t.shape[1]

    @staticmethod
    def encode(vectors: torch.Tensor) -> "BinaryCodes":
        """Codes of [N, D] vectors, ``_ENCODE_ROWS`` rows at a time (every
        row is encoded on its own)."""
        n, d = vectors.shape
        dev = vectors.device
        inv_d = f32_reciprocal(d)
        codes_t = torch.empty((d // 32, n), dtype=torch.int32, device=dev)
        scale = torch.empty(n, dtype=torch.float32, device=dev)
        resid = torch.empty(n, dtype=torch.float32, device=dev)
        popcnt = torch.empty(n, dtype=torch.float32, device=dev)
        for r0 in range(0, n, _ENCODE_ROWS):
            rows = slice(r0, min(n, r0 + _ENCODE_ROWS))
            v = vectors[rows].float()
            bits = v > 0
            codes_t[:, rows] = pack_bits(bits).T
            s = v.abs().sum(dim=-1) * inv_d  # jnp.mean: sum * f32(1/D)
            sq = (v * v).sum(dim=-1)
            scale[rows] = s
            resid[rows] = torch.sqrt((sq - s * s * d).clamp_min(0.0))
            popcnt[rows] = bits.sum(dim=-1).float()
        return BinaryCodes(codes_t=codes_t, scale=scale, resid=resid, popcnt=popcnt, dim=d)


def quantize_query_planes(
    q: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize queries to QUERY_BITS bit-planes.

    Returns (planes [B, P, D/32] int32 words, qmin [B], qstep [B], qsum [B]);
    q_d ~= qmin + qstep * Q_d with Q_d in [0, 2^P - 1].
    """
    q = q.float()
    levels = (1 << QUERY_BITS) - 1
    qmin = q.amin(dim=-1)
    qmax = q.amax(dim=-1)
    qstep = ((qmax - qmin) * _INV_LEVELS).clamp_min(1e-12)  # XLA: / 15 -> * f32(1/15)
    ql = torch.round((q - qmin[:, None]) / qstep[:, None]).to(torch.int32).clamp(0, levels)
    planes = torch.stack([pack_bits((ql >> p) & 1) for p in range(QUERY_BITS)], dim=1)
    return planes, qmin, qstep, q.sum(dim=-1)


def binary_query_params(queries: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(planes, qmin, qstep, qsum, qnorm) of f32 queries: what a binary scan
    needs of them."""
    q = queries.float()
    return (*quantize_query_planes(q), torch.linalg.vector_norm(q, dim=-1))


def _bit_dot_batch(codes_t: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """sum_p 2^p * popcount(codes & plane_p) for a batch of queries.

    codes_t: [W, N] int32 words; planes: [B, P, W] int32 words -> [B, N] f32
    (exact: at most (2^P - 1) * D)."""
    acc = torch.zeros(
        (planes.shape[0], codes_t.shape[1]), dtype=torch.int32, device=codes_t.device
    )
    for p in range(planes.shape[1]):
        for w in range(planes.shape[2]):
            anded = codes_t[w][None, :] & planes[:, p, w][:, None]
            acc += popcount(anded) << p
    return acc.float()


def binary_estimates(
    planes, qmin, qstep, qsum, qnorm, codes_t, scale, popcnt, resid, dim: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(estimates [B, N], bounds [B, N]) of the columns of ``codes_t``.

    Each operation rounds once, in the order of the Pallas body
    (``pallas_scan.py:567-571``) with XLA's products for its divisions by
    constants; the CUDA kernel (``csrc/binary_slot_scan.cu``) does the same
    operations, so its scores equal ``est + bound`` here bit for bit."""
    bd = _bit_dot_batch(codes_t, planes)
    dot_b_q = qmin[:, None] * popcnt[None, :] + qstep[:, None] * bd
    est = scale[None, :] * (2.0 * dot_b_q - qsum[:, None])
    # two independent error sources, combined in quadrature: the sign
    # decomposition's residual, ||r||*||q||/sqrt(D), and the 4-bit query
    # quantization, 2*s*sqrt(D)*qstep/sqrt(12)
    r = resid[None, :] * qnorm[:, None]
    var_resid = r * r * f32_reciprocal(dim)
    s2 = 2.0 * scale
    var_quant = (s2 * s2 * float(dim))[None, :] * (qstep * qstep)[:, None] * INV_12
    return est, EPSILON * torch.sqrt(var_resid + var_quant)


def binary_estimate_scores(
    bc: BinaryCodes, queries: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate dot(v, q) for all (query, vector) pairs from binary codes:
    (estimates [B, N], bounds [B, N]), the true dot lying within
    estimate +- bound with ~94% probability (a 1.9-sigma bound)."""
    return binary_estimates(
        *binary_query_params(queries), bc.codes_t, bc.scale, bc.popcnt, bc.resid, bc.dim
    )


def binary_rerank_budget(k: int) -> int:
    return min(BINARY_RERANK_FACTOR * k, RERANKING_LIMIT)


def binary_scan_candidates(
    bc: BinaryCodes,
    queries: torch.Tensor,
    k: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select rerank candidates by optimistic score (estimate + bound):
    ([B, C] scores, [B, C] ids), C = the rerank budget for k.

    The columns go in chunks, so no [B, N] matrix is held: each chunk's
    top-C is merged into the running top-C by a stable sort, which keeps
    the lower id first among equal scores, so the result equals one top-C
    over all columns."""
    params = binary_query_params(queries)
    n = bc.codes_t.shape[1]
    c = min(binary_rerank_budget(k), n)
    step = max(1024, _SCAN_ELEMS // max(queries.shape[0], 1))
    best_s = best_i = None
    for c0 in range(0, n, step):
        cols = slice(c0, min(n, c0 + step))
        est, bound = binary_estimates(
            *params, bc.codes_t[:, cols], bc.scale[cols], bc.popcnt[cols],
            bc.resid[cols], bc.dim,
        )
        top_s, top_i = masked_topk(
            est + bound, c, mask=None if mask is None else mask[cols]
        )
        top_i = torch.where(top_i >= 0, top_i + c0, -1)
        if best_s is not None:
            top_s = torch.cat([best_s, top_s], dim=-1)
            top_i = torch.cat([best_i, top_i], dim=-1)
        best_s, pos = torch.sort(top_s, dim=-1, descending=True, stable=True)
        best_s = best_s[:, :c]
        best_i = torch.gather(top_i, -1, pos[:, :c])
    return best_s, best_i

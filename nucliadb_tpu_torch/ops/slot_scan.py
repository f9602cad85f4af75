"""Top-1 and top-2-per-slot int8 scans: the CUDA kernel and its plain versions.

Counterparts of three wrappers of ``nucliadb_tpu/ops/pallas_scan.py``:

- ``int8_scan_slots_resident2`` (``_resident2_kernel``): each slot keeps
  its two best entries; the result is ``([B, 2S] scores, [B, 2S] ids)``,
  the top-1 table followed by the top-2 table;
- ``int8_scan_slots`` (``_scan_kernel``, the ``pallas`` flag route) and
  ``int8_scan_slots_resident`` (``_resident_kernel``, reached by no serving
  route): each slot keeps its best entry; ``([B, S], [B, S])``.

For B int8 queries against N int8 codes, column j scores
``f32(i32 dot) * scale[j] + bias[j]`` (bias 0, or ``NEG_INF`` where the mask
is False) and lands in slot ``j mod S``; a slot keeps its best (score, id)
under the order "score descending, then id ascending" (the Pallas kernels
insert with strict ``>`` in ascending column order). ``_scan_kernel`` masks
with a select rather than the bias: both give ``NEG_INF`` at every reachable
score, so the tables agree. A table depends on the slot map alone, never on
how N or B is tiled; the Pallas block sizes below only gate the routes.

Every wrapper takes its plain version for tensors on the CPU and launches
``csrc/int8_slot_scan.cu`` (in its top-1 or top-2 mode: ``wgmma`` on the
int8 tensor cores) for tensors on a CUDA device; there is no fallback
between the two. ``LAUNCHES`` counts kernel launches by mode, ``"top1"``
and ``"top2"``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import kernels
from ..utils.counts import LaunchCounter
from .quant import int8_dot

# Pallas' NEG_INF (f32 min), NOT topk.NEG_INF (-3e38): the slot tables and
# the NEG_INF/2 cut of their consumer are in this unit
NEG_INF = float(np.finfo(np.float32).min)

# the JAX package's block sizes, read at call time by the gates (tests
# shrink them as the JAX tests do)
BLOCK_N = 8192
SLOTS = 1024
BLOCK_B = 128
RESIDENT_BLOCK_N = 2048
RESIDENT_BLOCK_B = 512
RESIDENT_SLOTS = 512
RESIDENT_MAX_B = 1024
RESIDENT2_SLOTS = 256
RESIDENT2_MAX_B = 2048

# kernel launches since the last reset, by mode (chip_smoke.py reads them)
LAUNCHES = LaunchCounter()

_KERNEL_TILE_B = 128  # query rows per CTA (TILE_B in the source)
_KERNEL_D_ALIGN = 64  # TMA rows are 16-byte multiples; the kernel zero-fills D to 128
_KERNEL_MAX_D = 8192
_KERNEL_MAX_SLOTS = {1: 1024, 2: 256}  # by keep
_WAVES = 4  # waves of CTAs (one per SM) the column ranges are cut into at least
_REFERENCE_CHUNK = 32768  # columns per step of the plain version


def eligible(n: int, d: int, multi: bool, block_n: int | None = None) -> bool:
    """The shapes the JAX package sends to ``int8_scan_slots`` (the
    ``pallas`` flag route); the port takes the same gate."""
    block_n = block_n or BLOCK_N
    return (not multi) and n >= 2 * block_n and n % block_n == 0 and d % 128 == 0


def resident_eligible(
    n: int, d: int, b: int, multi: bool, block_n: int | None = None
) -> bool:
    block_n = block_n or RESIDENT_BLOCK_N
    return (
        (not multi)
        and n >= 2 * block_n
        and n % block_n == 0
        and d % 128 == 0
        and b <= RESIDENT_MAX_B
    )


def resident2_block_b(b: int) -> int:
    """Query rows per Pallas grid step (kept for parity with the gate; the
    CUDA kernel tiles on its own)."""
    cap = 256 if b > 1024 else RESIDENT_BLOCK_B
    block_b = min(b, cap)
    while b % block_b:
        block_b -= 1
    return block_b


def resident2_eligible(
    n: int, d: int, b: int, multi: bool, block_n: int | None = None
) -> bool:
    """The shapes the JAX package sends to the resident2 kernel; the port
    takes the same gate so both packages pick the same route."""
    block_n = block_n or RESIDENT_BLOCK_N
    return (
        (not multi)
        and n >= 2 * block_n
        and n % block_n == 0
        and d % 128 == 0
        and b <= RESIDENT2_MAX_B
    )


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _better(sa, ia, sb, ib):
    """(sa, ia) ranks before (sb, ib): score descending, then id ascending."""
    return (sa > sb) | ((sa == sb) & (ia < ib))


def merge_top1(a, b):
    """The better of two (s, i) tables under ``_better``."""
    a_first = _better(*a, *b)
    return torch.where(a_first, a[0], b[0]), torch.where(a_first, a[1], b[1])


def _merge_top2(a, b):
    """Top-2 of two sorted (s1, i1, s2, i2) tables under ``_better``."""
    a1s, a1i, a2s, a2i = a
    b1s, b1i, b2s, b2i = b
    a_first = _better(a1s, a1i, b1s, b1i)
    s1 = torch.where(a_first, a1s, b1s)
    i1 = torch.where(a_first, a1i, b1i)
    # runner-up: the loser of the two heads against the winner's second
    a_second = _better(a2s, a2i, b1s, b1i)  # when a won the head
    b_second = _better(a1s, a1i, b2s, b2i)  # when b won the head
    s2 = torch.where(
        a_first, torch.where(a_second, a2s, b1s), torch.where(b_second, a1s, b2s)
    )
    i2 = torch.where(
        a_first, torch.where(a_second, a2i, b1i), torch.where(b_second, a1i, b2i)
    )
    return s1, i1, s2, i2


def empty_table(b: int, slots: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The table every slot starts from: (NEG_INF, -1)."""
    return (
        torch.full((b, slots), NEG_INF, dtype=torch.float32, device=device),
        torch.full((b, slots), -1, dtype=torch.int32, device=device),
    )


def sorted_slot_chunks(n: int, slots: int, score_chunk):
    """Yield, for each chunk of whole slot rows of N columns, the chunk's
    scores sorted per slot, ``([B, r, S] scores, [B, r, S] int32 ids)``:
    a stable descending sort along the r rows, so among equal scores the
    lower id comes first. ``score_chunk(c0, c1)`` gives the [B, c1 - c0]
    scores of columns [c0, c1)."""
    if n % slots:
        raise ValueError(f"N={n} is not a multiple of slots={slots}")
    chunk = max(slots, _REFERENCE_CHUNK // slots * slots)
    slot_iota = None
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        scores = score_chunk(c0, c1)
        if slot_iota is None:
            slot_iota = torch.arange(slots, dtype=torch.int32, device=scores.device)
        r = (c1 - c0) // slots
        srt, pos = torch.sort(
            scores.view(scores.shape[0], r, slots), dim=1, descending=True, stable=True
        )
        yield srt, (c0 + pos.to(torch.int32) * slots + slot_iota).to(torch.int32)


def _int8_chunk_scores(q_codes, codes, scale, mask):
    def score_chunk(c0, c1):
        raw = int8_dot(q_codes, codes[c0:c1]).float()
        bias = torch.where(mask[c0:c1], 0.0, NEG_INF)
        # two roundings, as the kernel's __fmul_rn / __fadd_rn
        return raw * scale[c0:c1] + bias

    return score_chunk


def int8_scan_slots_resident2_reference(
    q_codes: torch.Tensor,  # [B, D] int8
    codes: torch.Tensor,  # [N, D] int8, N a multiple of slots
    scale: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    slots: int = RESIDENT2_SLOTS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the top-2 slot table, on any device.

    Works in chunks of columns (``sorted_slot_chunks``): each chunk gives
    each slot's two best, and a lexicographic merge folds them into the
    running table, which starts at (NEG_INF, -1)."""
    empty = empty_table(q_codes.shape[0], slots, codes.device)
    table = empty * 2
    for srt, ids in sorted_slot_chunks(
        codes.shape[0], slots, _int8_chunk_scores(q_codes, codes, scale, mask)
    ):
        second = (srt[:, 1], ids[:, 1]) if srt.shape[1] > 1 else empty
        table = _merge_top2(table, (srt[:, 0], ids[:, 0], *second))
    s1, i1, s2, i2 = table
    return torch.cat([s1, s2], dim=-1), torch.cat([i1, i2], dim=-1)


def int8_scan_slots_top1_reference(
    q_codes: torch.Tensor,  # [B, D] int8
    codes: torch.Tensor,  # [N, D] int8, N a multiple of slots
    scale: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    slots: int = SLOTS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the top-1 slot table ([B, S] scores, [B, S]
    ids), on any device: the chunks of the top-2 version, keeping one entry
    per slot."""
    table = empty_table(q_codes.shape[0], slots, codes.device)
    for srt, ids in sorted_slot_chunks(
        codes.shape[0], slots, _int8_chunk_scores(q_codes, codes, scale, mask)
    ):
        table = merge_top1(table, (srt[:, 0], ids[:, 0]))
    return table


# --------------------------------------------------------------------------
# The CUDA kernel
# --------------------------------------------------------------------------


def kernel_tile_width(slots: int) -> int:
    """Slots of a CTA's group (W in the source): the product's N, 64 where
    it divides S, else 32."""
    return 64 if slots % 64 == 0 else 32


def kernel_tiling(b: int, n: int, slots: int, sm_count: int) -> tuple[int, int]:
    """(columns per range, number of ranges) for the tensor-core kernel's
    grid (query tiles of 128 rows, column ranges, slot groups of
    ``kernel_tile_width`` slots), one CTA per SM. A range is a whole number
    of slot rows. Of the range counts that give at least
    ``_WAVES`` waves of CTAs (or one range per slot row), it takes the one
    whose last wave is fullest, the fewest ranges on a tie."""
    rows = n // slots
    tiles = -(-b // _KERNEL_TILE_B) * (slots // kernel_tile_width(slots))
    lo = min(rows, max(1, -(-sm_count * _WAVES // tiles)))
    best = None
    for want in range(lo, min(rows, 2 * lo) + 1):
        per = -(-rows // want)
        count = -(-rows // per)
        ctas = tiles * count
        fill = ctas / (-(-ctas // sm_count) * sm_count)
        if best is None or fill > best[0]:
            best = (fill, per)
    per = best[1]
    return per * slots, -(-rows // per)


def check_tensors(dev, specs) -> None:
    """Each (name, tensor, dtype) lies on ``dev``, has the dtype, is
    contiguous and 16-byte aligned."""
    for name, t, dtype in specs:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_kernel_inputs(q_codes, codes, scale, mask, slots, keep=2):
    if keep not in _KERNEL_MAX_SLOTS:
        raise ValueError(f"keep={keep} must be 1 or 2")
    check_tensors(q_codes.device, (
        ("q_codes", q_codes, torch.int8),
        ("codes", codes, torch.int8),
        ("scale", scale, torch.float32),
        ("mask", mask, torch.bool),
    ))
    b, d = q_codes.shape
    n = codes.shape[0]
    if codes.shape != (n, d) or scale.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"shapes q {tuple(q_codes.shape)} codes {tuple(codes.shape)} "
            f"scale {tuple(scale.shape)} mask {tuple(mask.shape)} disagree"
        )
    max_slots = _KERNEL_MAX_SLOTS[keep]
    if slots % 32 or not 32 <= slots <= max_slots:
        raise ValueError(f"slots={slots} must be a multiple of 32 in [32, {max_slots}]")
    if n == 0 or n % slots:
        raise ValueError(f"N={n} must be a positive multiple of slots={slots}")
    if d == 0 or d % _KERNEL_D_ALIGN or d > _KERNEL_MAX_D:
        raise ValueError(
            f"D={d} must be a multiple of {_KERNEL_D_ALIGN} up to {_KERNEL_MAX_D}"
        )
    if b == 0:
        raise ValueError("empty query batch")


def _launch_kernel(q_codes, codes, scale, mask, slots, keep):
    _check_kernel_inputs(q_codes, codes, scale, mask, slots, keep)
    b, d = q_codes.shape
    n = codes.shape[0]
    dev = q_codes.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_range, n_ranges = kernel_tiling(b, n, slots, sm_count)
    width = keep * slots
    out_s = torch.empty((b, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, width), dtype=torch.int32, device=dev)
    part_s = torch.empty((n_ranges, b, width), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_ranges, b, width), dtype=torch.int32, device=dev)
    fn = kernels.load("int8_slot_scan").int8_slot_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q_codes.data_ptr(), codes.data_ptr(), scale.data_ptr(), mask.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, n, d, slots, n_range, keep, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"int8_slot_scan (keep={keep}) launch failed: error {err} "
            "(a CUDA error, or -2: the driver's tensor-map encoder is missing or refused a map)"
        )
    LAUNCHES.add(f"top{keep}")
    return out_s, out_i


def _dispatch(q_codes, codes, scale, mask, slots, keep):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if q_codes.device.type == "cpu":
        reference = (
            int8_scan_slots_top1_reference if keep == 1 else int8_scan_slots_resident2_reference
        )
        return reference(q_codes, codes, scale, mask, slots=slots)
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    return _launch_kernel(q_codes, codes, scale, mask, slots, keep)


# --------------------------------------------------------------------------
# The wrappers (the JAX package's signatures)
# --------------------------------------------------------------------------


def int8_scan_slots_resident2(
    q_codes: torch.Tensor,
    codes: torch.Tensor,
    scale: torch.Tensor,
    mask: torch.Tensor,
    *,
    slots: int = RESIDENT2_SLOTS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, 2S] slot scores, [B, 2S] slot ids): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (raising on what it does not
    take)."""
    return _dispatch(q_codes, codes, scale, mask, slots, keep=2)


def int8_scan_slots(
    q_codes: torch.Tensor,  # [B, D] int8 quantized queries
    codes: torch.Tensor,  # [N, D] int8 (N a multiple of block_n)
    scale: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    block_n: int | None = None,
    slots: int | None = None,
    block_b: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, S] slot scores, [B, S] slot ids), top-1 per slot ``j mod S``.
    Asserts what the Pallas wrapper asserts; the kernel tiles on its own."""
    block_n = block_n or BLOCK_N
    slots = slots or SLOTS
    n, b = codes.shape[0], q_codes.shape[0]
    if block_b is None:
        block_b = min(b, BLOCK_B)
        while b % block_b:
            block_b -= 1
    assert n % block_n == 0, (n, block_n)
    assert b % block_b == 0, (b, block_b)
    assert block_n % slots == 0 and block_n >= slots, (block_n, slots)
    return _dispatch(q_codes, codes, scale, mask, slots, keep=1)


def int8_scan_slots_resident(
    q_codes: torch.Tensor,  # [B, D] int8 (B a multiple of block_b, <= RESIDENT_MAX_B)
    codes: torch.Tensor,  # [N, D] int8 (N a multiple of block_n)
    scale: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    block_n: int | None = None,
    slots: int | None = None,
    block_b: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, S] slot scores, [B, S] slot ids): the same top-1 table as
    ``int8_scan_slots``, under the resident Pallas wrapper's asserts."""
    block_n = block_n or RESIDENT_BLOCK_N
    slots = slots or RESIDENT_SLOTS
    n, b = codes.shape[0], q_codes.shape[0]
    if block_b is None:
        block_b = min(b, RESIDENT_BLOCK_B)
    assert n % block_n == 0, (n, block_n)
    assert b % block_b == 0 and b <= RESIDENT_MAX_B, (b, block_b)
    assert block_n % slots == 0 and block_n >= slots, (block_n, slots)
    return _dispatch(q_codes, codes, scale, mask, slots, keep=1)

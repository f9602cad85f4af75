"""Top-2-per-slot int8 scan: the CUDA kernel and its plain version.

Counterpart of ``int8_scan_slots_resident2`` / ``_resident2_kernel`` in
``nucliadb_tpu/ops/pallas_scan.py``. For B int8 queries against N int8
codes, column j scores ``f32(i32 dot) * scale[j] + bias[j]`` (bias 0, or
``NEG_INF`` where the mask is False) and lands in slot ``j mod S``; each
slot keeps its two best (score, id) under the order "score descending, then
id ascending" (the Pallas kernel inserts with strict ``>`` in ascending
column order). The result is ``([B, 2S] scores, [B, 2S] ids)``: the top-1
table followed by the top-2 table. It depends on the slot map alone, never
on how N or B is tiled.

``int8_scan_slots_resident2`` takes the plain version for tensors on the
CPU and launches ``csrc/int8_slot_scan.cu`` for tensors on a CUDA device;
there is no fallback between the two. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import kernels
from .quant import int8_dot

# Pallas' NEG_INF (f32 min), NOT topk.NEG_INF (-3e38): the slot tables and
# the NEG_INF/2 cut of their consumer are in this unit
NEG_INF = float(np.finfo(np.float32).min)

RESIDENT_BLOCK_N = 2048
RESIDENT_BLOCK_B = 512
RESIDENT2_SLOTS = 256
RESIDENT2_MAX_B = 2048

# kernel launches since the last reset (chip_smoke.py reads and resets it)
LAUNCHES = 0

_KERNEL_BLOCK_B = 16  # queries per CUDA block (BT in the source)
_KERNEL_D_ALIGN = 64  # the kernel stages D in 64-byte chunks
_KERNEL_MAX_D = 8192  # the query tile [16, D] stays in shared memory
_KERNEL_MAX_SLOTS = 256  # one thread per slot, __launch_bounds__(256)
_BLOCKS_PER_SM = 2  # resident blocks per SM under __launch_bounds__(256, 2)
_WAVES = 4  # waves of resident blocks the column ranges are cut into
_REFERENCE_CHUNK = 32768  # columns per step of the plain version


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


def _better(sa, ia, sb, ib):
    """(sa, ia) ranks before (sb, ib): score descending, then id ascending."""
    return (sa > sb) | ((sa == sb) & (ia < ib))


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


def int8_scan_slots_resident2_reference(
    q_codes: torch.Tensor,  # [B, D] int8
    codes: torch.Tensor,  # [N, D] int8, N a multiple of slots
    scale: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    slots: int = RESIDENT2_SLOTS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the slot table, on any device.

    Works in chunks of columns: each chunk's scores reshape to [B, r, S],
    a stable descending sort along r gives each slot's two best (lower id
    first among equal scores), and a lexicographic merge folds them into
    the running table, which starts at (NEG_INF, -1)."""
    n, _ = codes.shape
    b = q_codes.shape[0]
    if n % slots:
        raise ValueError(f"N={n} is not a multiple of slots={slots}")
    dev = codes.device
    empty = (
        torch.full((b, slots), NEG_INF, dtype=torch.float32, device=dev),
        torch.full((b, slots), -1, dtype=torch.int32, device=dev),
    )
    table = empty * 2
    slot_iota = torch.arange(slots, dtype=torch.int32, device=dev)
    chunk = max(slots, _REFERENCE_CHUNK // slots * slots)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        raw = int8_dot(q_codes, codes[c0:c1]).float()
        bias = torch.where(mask[c0:c1], 0.0, NEG_INF)
        # two roundings, as the kernel's __fmul_rn / __fadd_rn
        scores = raw * scale[c0:c1] + bias
        r = (c1 - c0) // slots
        srt, pos = torch.sort(
            scores.view(b, r, slots), dim=1, descending=True, stable=True
        )
        ids = (c0 + pos.to(torch.int32) * slots + slot_iota).to(torch.int32)
        second = (srt[:, 1], ids[:, 1]) if r > 1 else empty
        table = _merge_top2(table, (srt[:, 0], ids[:, 0], *second))
    s1, i1, s2, i2 = table
    return torch.cat([s1, s2], dim=-1), torch.cat([i1, i2], dim=-1)


def _kernel_tiling(b: int, n: int, slots: int, sm_count: int) -> tuple[int, int]:
    """(columns per block, number of column ranges): about ``_WAVES`` waves
    of resident blocks on a card of ``sm_count`` SMs; a range is a whole
    number of slot rows."""
    q_tiles = -(-b // _KERNEL_BLOCK_B)
    target = sm_count * _BLOCKS_PER_SM * _WAVES
    want = max(1, -(-target // q_tiles))
    rows = n // slots
    rows_per_range = max(1, -(-rows // want))
    n_range = rows_per_range * slots
    return n_range, -(-n // n_range)


def _check_kernel_inputs(q_codes, codes, scale, mask, slots):
    dev = q_codes.device
    for name, t, dtype in (
        ("q_codes", q_codes, torch.int8),
        ("codes", codes, torch.int8),
        ("scale", scale, torch.float32),
        ("mask", mask, torch.bool),
    ):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q_codes on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, d = q_codes.shape
    n = codes.shape[0]
    if codes.shape != (n, d) or scale.shape != (n,) or mask.shape != (n,):
        raise ValueError(
            f"shapes q {tuple(q_codes.shape)} codes {tuple(codes.shape)} "
            f"scale {tuple(scale.shape)} mask {tuple(mask.shape)} disagree"
        )
    if slots % 32 or not 32 <= slots <= _KERNEL_MAX_SLOTS:
        raise ValueError(
            f"slots={slots} must be a multiple of 32 in [32, {_KERNEL_MAX_SLOTS}]"
        )
    if n == 0 or n % slots:
        raise ValueError(f"N={n} must be a positive multiple of slots={slots}")
    if d == 0 or d % _KERNEL_D_ALIGN or d > _KERNEL_MAX_D:
        raise ValueError(
            f"D={d} must be a multiple of {_KERNEL_D_ALIGN} up to {_KERNEL_MAX_D}"
        )
    if b == 0:
        raise ValueError("empty query batch")


def _launch_kernel(q_codes, codes, scale, mask, slots):
    global LAUNCHES
    _check_kernel_inputs(q_codes, codes, scale, mask, slots)
    b, d = q_codes.shape
    n = codes.shape[0]
    dev = q_codes.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_range, n_ranges = _kernel_tiling(b, n, slots, sm_count)
    out_s = torch.empty((b, 2 * slots), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, 2 * slots), dtype=torch.int32, device=dev)
    part_s = torch.empty((n_ranges, b, 2 * slots), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_ranges, b, 2 * slots), dtype=torch.int32, device=dev)
    lib = kernels.load("int8_slot_scan")
    fn = lib.int8_slot_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q_codes.data_ptr(), codes.data_ptr(), scale.data_ptr(), mask.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, n, d, slots, n_range, stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_slot_scan launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out_s, out_i


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
    if q_codes.device.type == "cpu":
        return int8_scan_slots_resident2_reference(
            q_codes, codes, scale, mask, slots=slots
        )
    if q_codes.device.type != "cuda":
        raise ValueError(f"unsupported device {q_codes.device}")
    return _launch_kernel(q_codes, codes, scale, mask, slots)

"""Top-1-per-slot binary (sign-code) scan: the CUDA kernel and its plain version.

Counterpart of ``binary_scan_slots`` / ``_binary_scan_kernel`` in
``nucliadb_tpu/ops/pallas_scan.py``. For B queries, given as 4 bit-planes
and their scalars (``quant.binary_query_params``), against the N binary
codes of ``quant.BinaryCodes``, column j scores its optimistic estimate

    bd  = sum_p 2^p * popcount(code[:, j] & plane_p)
    est = scale * (2 * (qmin * popcnt + qstep * bd) - qsum)
    opt = est + 1.9 * sqrt((resid * qnorm)^2 / D + (2 * scale)^2 * D * qstep^2 / 12)

(``NEG_INF`` where the mask is False) and lands in slot ``j mod S``, which
keeps its best (score, id) under "score descending, then id ascending".
The result is ``([B, S] scores, [B, S] ids)``; it depends on the slot map
alone, never on how N or B is tiled.

``binary_scan_slots`` takes the plain version for tensors on the CPU and
launches ``csrc/binary_slot_scan.cu`` for tensors on a CUDA device; there
is no fallback between the two. Both round every operation once, in the
same order (``quant.binary_estimates``), so on the card they agree bit for
bit. ``LAUNCHES["binary"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from ..utils.counts import LaunchCounter
from . import quant, slot_scan
from .slot_scan import NEG_INF

BINARY_BLOCK_N = 8192  # the Pallas kernel's lanes per grid step (gate only)

# kernel launches since the last reset (chip_smoke.py reads it)
LAUNCHES = LaunchCounter()

_KERNEL_BLOCK_B = 16  # queries per CUDA block (BQ in the source)
_BLOCKS_PER_SM = 3  # resident blocks per SM under __launch_bounds__(256, 3)
_KERNEL_MAX_WORDS = 256  # D <= 8192: the planes of 16 queries in shared memory
_KERNEL_MAX_SLOTS = 1024  # a block holds up to 256 slots, a grid 4 groups
_KERNEL_THREADS = 256  # threads per CUDA block at most, one slot each
_WAVES = 4  # waves of resident blocks the column ranges are cut into
_PLANES = quant.QUERY_BITS


def binary_block_for(n: int, b: int, slots: int | None = None) -> int:
    """The Pallas kernel's block: the largest that divides n and keeps its
    [B, Nb] temporaries inside its budget of 32 * 8192 elements. The port's
    route gate calls it as the JAX package does; the CUDA kernel tiles on
    its own."""
    slots = slots or slot_scan.SLOTS
    block = BINARY_BLOCK_N
    budget = 32 * 8192
    while block > slots and (b * block > budget or n % block != 0):
        block //= 2
    return block


def binary_eligible(n: int, d: int, multi: bool, block_n: int | None = None) -> bool:
    block_n = block_n or BINARY_BLOCK_N
    return (not multi) and n >= 2 * block_n and n % block_n == 0 and d % 128 == 0


def binary_scan_slots_reference(
    planes, qmin, qstep, qsum, qnorm, codes_t, scale, popcnt, resid, mask,
    *,
    dim: int,
    slots: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the slot table, on any device: chunks of
    columns (``slot_scan.sorted_slot_chunks``) folded into a running top-1
    table that starts at (NEG_INF, -1)."""
    slots = slots or slot_scan.SLOTS

    def score_chunk(c0, c1):
        cols = slice(c0, c1)
        est, bound = quant.binary_estimates(
            planes, qmin, qstep, qsum, qnorm, codes_t[:, cols], scale[cols],
            popcnt[cols], resid[cols], dim,
        )
        return torch.where(mask[cols], est + bound, NEG_INF)

    table = slot_scan.empty_table(planes.shape[0], slots, codes_t.device)
    for srt, ids in slot_scan.sorted_slot_chunks(codes_t.shape[1], slots, score_chunk):
        table = slot_scan.merge_top1(table, (srt[:, 0], ids[:, 0]))
    return table


def kernel_tiling(b: int, n: int, slots: int, sm_count: int) -> tuple[int, int]:
    """(columns per range, number of ranges) for the popcount kernel's grid
    (query tiles of ``_KERNEL_BLOCK_B``, column ranges, slot groups of up to
    256 slots): about ``_WAVES`` waves of ``_BLOCKS_PER_SM`` resident blocks
    on a card of ``sm_count`` SMs. A range is a whole number of slot rows."""
    groups = slots // min(slots, _KERNEL_THREADS)
    tiles = -(-b // _KERNEL_BLOCK_B) * groups
    target = sm_count * _BLOCKS_PER_SM * _WAVES
    want = max(1, -(-target // tiles))
    rows = n // slots
    rows_per_range = max(1, -(-rows // want))
    n_range = rows_per_range * slots
    return n_range, -(-n // n_range)


def _check_slots(slots: int) -> None:
    """A block holds min(S, 256) slots, so S is a multiple of 32 up to 256,
    or a multiple of 256 above."""
    if (
        slots % 32
        or not 32 <= slots <= _KERNEL_MAX_SLOTS
        or (slots > _KERNEL_THREADS and slots % _KERNEL_THREADS)
    ):
        raise ValueError(
            f"slots={slots} must be a multiple of 32 in [32, {_KERNEL_THREADS}] "
            f"or of {_KERNEL_THREADS} up to {_KERNEL_MAX_SLOTS}"
        )


def _check_kernel_inputs(planes, qparams, codes_t, columns, mask, dim, slots):
    """qparams: (qmin, qstep, qsum, qnorm); columns: (scale, popcnt, resid)."""
    dev = planes.device
    slot_scan.check_tensors(dev, (
        ("planes", planes, torch.int32),
        ("codes_t", codes_t, torch.int32),
        ("mask", mask, torch.bool),
        *((name, t, torch.float32) for name, t in zip(("qmin", "qstep", "qsum", "qnorm"), qparams)),
        *((name, t, torch.float32) for name, t in zip(("scale", "popcnt", "resid"), columns)),
    ))
    if planes.dim() != 3 or codes_t.dim() != 2:
        raise ValueError(f"planes {tuple(planes.shape)} / codes_t {tuple(codes_t.shape)} rank")
    b, p, w = planes.shape
    n = codes_t.shape[1]
    if p != _PLANES:
        raise ValueError(f"{p} query planes; the kernel takes {_PLANES}")
    if codes_t.shape[0] != w or dim != 32 * w:
        raise ValueError(f"codes_t {tuple(codes_t.shape)}, planes {tuple(planes.shape)} and dim={dim} disagree")
    if any(t.shape != (b,) for t in qparams) or any(t.shape != (n,) for t in (*columns, mask)):
        raise ValueError("query scalars must be [B] and column scalars [N]")
    _check_slots(slots)
    if n == 0 or n % slots:
        raise ValueError(f"N={n} must be a positive multiple of slots={slots}")
    if w == 0 or w > _KERNEL_MAX_WORDS:
        raise ValueError(f"W={w} words must be in [1, {_KERNEL_MAX_WORDS}]")
    if b == 0:
        raise ValueError("empty query batch")


def _launch_kernel(planes, qparams, codes_t, columns, mask, dim, slots):
    _check_kernel_inputs(planes, qparams, codes_t, columns, mask, dim, slots)
    b, _, w = planes.shape
    n = codes_t.shape[1]
    dev = planes.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    n_range, n_ranges = kernel_tiling(b, n, slots, sm_count)
    out_s = torch.empty((b, slots), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, slots), dtype=torch.int32, device=dev)
    part_s = torch.empty((n_ranges, b, slots), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_ranges, b, slots), dtype=torch.int32, device=dev)
    fn = kernels.load("binary_slot_scan").binary_slot_scan
    fn.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            planes.data_ptr(), *(t.data_ptr() for t in qparams), codes_t.data_ptr(),
            *(t.data_ptr() for t in columns), mask.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            b, n, w, slots, n_range,
            float(dim), quant.f32_reciprocal(dim), quant.INV_12, quant.EPSILON, stream,
        )
    if err != 0:
        raise RuntimeError(f"binary_slot_scan launch failed: CUDA error {err}")
    LAUNCHES.add("binary")
    return out_s, out_i


def binary_scan_slots(
    planes: torch.Tensor,  # [B, P, W] int32 query bit-planes
    qmin: torch.Tensor,  # [B] f32
    qstep: torch.Tensor,  # [B] f32
    qsum: torch.Tensor,  # [B] f32
    qnorm: torch.Tensor,  # [B] f32
    codes_t: torch.Tensor,  # [W, N] int32 (transposed sign codes)
    scale: torch.Tensor,  # [N] f32
    popcnt: torch.Tensor,  # [N] f32
    resid: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] bool
    *,
    dim: int,
    block_n: int | None = None,
    slots: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """([B, S] optimistic slot scores, [B, S] slot ids): the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors (raising on what it
    does not take). Asserts what the Pallas wrapper asserts."""
    block_n = block_n or BINARY_BLOCK_N
    slots = slots or slot_scan.SLOTS
    n = codes_t.shape[1]
    assert n % block_n == 0, (n, block_n)
    assert block_n % slots == 0 and block_n >= slots, (block_n, slots)
    qparams = (qmin, qstep, qsum, qnorm)
    columns = (scale, popcnt, resid)
    if planes.device.type == "cpu":
        return binary_scan_slots_reference(
            planes, *qparams, codes_t, *columns, mask, dim=dim, slots=slots
        )
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    return _launch_kernel(planes, qparams, codes_t, columns, mask, dim, slots)

"""Top-1 and top-2 slot scans of the port against the Pallas kernels in
interpret mode.

The port's plain versions (the route a CPU tensor takes) must give the same
tables as ``nucliadb_tpu.ops.pallas_scan.int8_scan_slots_resident2``,
``int8_scan_slots`` and ``int8_scan_slots_resident`` (``interpret=True``),
bit for bit, scores and ids: they compute the same f32 roundings and the
same order (score descending, then id ascending). The CUDA kernel is held
to the plain versions on the card in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucliadb_tpu.ops import pallas_scan
from nucliadb_tpu_torch.ops import slot_scan
from torch_test_helpers import CASES, _planted_ties


def _jax_table(q, codes, scale, mask, slots):
    s, i = pallas_scan.int8_scan_slots_resident2(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(mask),
        block_n=1024, slots=slots, block_b=4, interpret=True,
    )
    return np.asarray(s), np.asarray(i)


def _torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("slots", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_slot_scan_bit_identical_to_pallas(case, slots):
    rng = np.random.default_rng(11)
    q, codes, scale, mask = CASES[case](rng, slots)
    js, ji = _jax_table(q, codes, scale, mask, slots)
    launches = dict(slot_scan.LAUNCHES)
    ts, ti = slot_scan.int8_scan_slots_resident2(*_torch_args(q, codes, scale, mask), slots=slots)
    assert dict(slot_scan.LAUNCHES) == launches  # CPU tensors: the plain version
    assert ts.shape == (q.shape[0], 2 * slots) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), ji)
    if case == "all_masked":
        assert (ti.numpy() == -1).all()


def test_planted_ties_keep_lower_ids_first():
    """Among equal scores in one slot the lower id is the slot's best and
    the next one its second; later copies are dropped."""
    slots = 128
    q, codes, scale, mask = _planted_ties(np.random.default_rng(11), slots)
    ts, ti = slot_scan.int8_scan_slots_resident2(*_torch_args(q, codes, scale, mask), slots=slots)
    ti = ti.numpy()
    assert ti[0, 5] == 5 and ti[0, slots + 5] == 5 + slots
    assert ti[0, 6] == 6 and ti[0, 700 % slots] == 700


_TOP1 = {
    # (JAX wrapper, port wrapper): the first masks with a select, the
    # second with a bias; both must give the plain version's table
    "int8_scan_slots": (pallas_scan.int8_scan_slots, slot_scan.int8_scan_slots),
    "int8_scan_slots_resident": (
        pallas_scan.int8_scan_slots_resident, slot_scan.int8_scan_slots_resident,
    ),
}


@pytest.mark.parametrize("wrapper", sorted(_TOP1))
@pytest.mark.parametrize("slots", [256, 512])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_top1_slot_scan_bit_identical_to_pallas(case, slots, wrapper):
    rng = np.random.default_rng(11)
    q, codes, scale, mask = CASES[case](rng, slots)
    jax_fn, port_fn = _TOP1[wrapper]
    js, ji = jax_fn(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(mask),
        block_n=1024, slots=slots, block_b=4, interpret=True,
    )
    args = _torch_args(q, codes, scale, mask)
    launches = dict(slot_scan.LAUNCHES)
    ts, ti = port_fn(*args, block_n=1024, slots=slots, block_b=4)
    assert dict(slot_scan.LAUNCHES) == launches  # CPU tensors: the plain version
    assert ts.shape == (q.shape[0], slots) and ti.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the top-1 table is the first half of the top-2 table at the same S
    s2, i2 = slot_scan.int8_scan_slots_top1_reference(*args, slots=slots)
    t2s, t2i = slot_scan.int8_scan_slots_resident2_reference(*args, slots=slots)
    assert torch.equal(s2, t2s[:, :slots]) and torch.equal(i2, t2i[:, :slots])
    if case == "all_masked":
        assert (ti.numpy() == -1).all()


def test_top1_wrappers_assert_as_pallas():
    q = torch.zeros((24, 128), dtype=torch.int8)
    codes = torch.zeros((4096, 128), dtype=torch.int8)
    scale, mask = torch.ones(4096), torch.ones(4096, dtype=torch.bool)
    with pytest.raises(AssertionError):  # N % block_n
        slot_scan.int8_scan_slots(q, codes, scale, mask, block_n=3072, slots=256)
    with pytest.raises(AssertionError):  # block_n % slots
        slot_scan.int8_scan_slots(q, codes, scale, mask, block_n=1024, slots=384)
    with pytest.raises(AssertionError):  # B % block_b
        slot_scan.int8_scan_slots(q, codes, scale, mask, block_n=1024, slots=256, block_b=5)
    big = torch.zeros((2048, 128), dtype=torch.int8)
    with pytest.raises(AssertionError):  # B above RESIDENT_MAX_B
        slot_scan.int8_scan_slots_resident(big, codes, scale, mask, block_n=1024, slots=256)
    # the defaults are the JAX package's
    assert (slot_scan.BLOCK_N, slot_scan.SLOTS, slot_scan.BLOCK_B) == (
        pallas_scan.BLOCK_N, pallas_scan.SLOTS, pallas_scan.BLOCK_B,
    )
    assert (
        slot_scan.RESIDENT_BLOCK_N, slot_scan.RESIDENT_BLOCK_B,
        slot_scan.RESIDENT_SLOTS, slot_scan.RESIDENT_MAX_B,
    ) == (
        pallas_scan.RESIDENT_BLOCK_N, pallas_scan.RESIDENT_BLOCK_B,
        pallas_scan.RESIDENT_SLOTS, pallas_scan.RESIDENT_MAX_B,
    )


@pytest.mark.parametrize("b", [1, 8, 12, 192, 1024, 1536, 2048, 3072])
def test_top1_gates_match_jax(b):
    for n in (2048, 4096, 8192, 16384, 24576, 1048576, 786432, 1000000):
        for d in (64, 128, 384, 768, 100):
            for block_n in (None, 512, 8192):
                assert slot_scan.eligible(n, d, False, block_n) == pallas_scan.eligible(
                    n, d, False, block_n
                ), (n, d, block_n)
                assert slot_scan.resident_eligible(
                    n, d, b, False, block_n
                ) == pallas_scan.resident_eligible(n, d, b, False, block_n), (n, d, b, block_n)
            assert not slot_scan.eligible(n, d, True)
            assert not slot_scan.resident_eligible(n, d, b, True)


@pytest.mark.parametrize("b", [1, 8, 12, 192, 1024, 1536, 2048, 3072])
def test_gate_and_block_b_match_jax(b):
    for n in (2048, 4096, 6144, 8192, 1048576, 786432, 1000000):
        for d in (64, 128, 384, 768, 100):
            assert slot_scan.resident2_eligible(n, d, b, False) == pallas_scan.resident2_eligible(
                n, d, b, False
            ), (n, d, b)
            assert not slot_scan.resident2_eligible(n, d, b, True)
    assert slot_scan.resident2_block_b(b) == pallas_scan.resident2_block_b(b)
    assert slot_scan.NEG_INF == pallas_scan.NEG_INF
    assert slot_scan.RESIDENT2_SLOTS == pallas_scan.RESIDENT2_SLOTS


@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize(
    "b,n,slots",
    [
        (8, 4096, 256), (2048, 1048576, 256), (12, 6144, 128), (2048, 1048576, 1024), (8, 16384, 512),
        (1024, 1048576, 512), (1, 65536, 32), (65, 65536, 32), (2047, 65536, 1024), (3, 96, 96),
        (2048, 33554432, 32),
    ],
)
def test_kernel_tiling_covers_columns(b, n, slots, sm_count):
    n_range, n_ranges = slot_scan.kernel_tiling(b, n, slots, sm_count)
    assert n_range % slots == 0  # whole slot rows
    assert (n_ranges - 1) * n_range < n <= n_ranges * n_range  # the ranges cover N, none empty
    assert n_ranges <= 65535  # CUDA grid.y limit
    assert slots % slot_scan.kernel_tile_width(slots) == 0


@pytest.mark.parametrize(
    "b,n,slots", [(2048, 1048576, 256), (2048, 1048576, 1024), (1024, 1048576, 512)]
)
def test_kernel_tiling_fills_the_card_at_the_timed_shapes(b, n, slots):
    """At chip_smoke's timed shapes the grid (128-row query tiles x ranges
    x slot groups, one CTA per SM) gives every one of 132 SMs several CTAs,
    and its last wave is at least 90 % full."""
    _, n_ranges = slot_scan.kernel_tiling(b, n, slots, 132)
    ctas = -(-b // 128) * (slots // slot_scan.kernel_tile_width(slots)) * n_ranges
    assert ctas >= 4 * 132
    assert ctas / (-(-ctas // 132) * 132) >= 0.9


@pytest.mark.parametrize("keep", [1, 2])
def test_kernel_input_checks_raise(keep):
    q = torch.zeros((8, 128), dtype=torch.int8)
    codes = torch.zeros((4096, 128), dtype=torch.int8)
    scale = torch.ones(4096)
    mask = torch.ones(4096, dtype=torch.bool)
    slot_scan._check_kernel_inputs(q, codes, scale, mask, 256, keep)  # accepted
    bad = [
        (q.float(), codes, scale, mask, 256),  # dtype
        (q, codes[:, :96], scale, mask, 256),  # D disagrees
        (q, codes, scale.double(), mask, 256),
        (q, codes, scale, mask[:100], 256),
        (q, codes, scale, mask, 100),  # slots not a multiple of 32
        (q, codes, scale, mask, 384),  # does not divide N (and above 256 for keep 2)
        (q, codes, scale, mask, 2048),  # more slots than the top-1 mode's 1024
        (q, codes[:4000], scale[:4000], mask[:4000], 256),  # N % S
        (q[:, :96], codes[:, :96].contiguous(), scale, mask, 256),  # D % 64
        (q, codes.t().contiguous().t(), scale, mask, 256),  # not contiguous
    ]
    # any multiple of 32 that divides N: up to 1024 slots in the top-1 mode, 256 in the top-2
    wide = (q, codes[:3072], scale[:3072], mask[:3072])
    slot_scan._check_kernel_inputs(*wide, 96, keep)
    if keep == 1:
        slot_scan._check_kernel_inputs(q, codes, scale, mask, 512, keep)
        slot_scan._check_kernel_inputs(*wide, 384, keep)
    else:
        bad.append((q, codes, scale, mask, 512))
        bad.append((*wide, 384))
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            slot_scan._check_kernel_inputs(*args, keep)
    with pytest.raises(ValueError):
        slot_scan._check_kernel_inputs(q, codes, scale, mask, 256, 3)

"""Top-2 slot scan of the port against the Pallas kernel in interpret mode.

The port's plain version (the route a CPU tensor takes) must give the same
table as ``nucliadb_tpu.ops.pallas_scan.int8_scan_slots_resident2(...,
interpret=True)``, bit for bit, scores and ids: both compute the same f32
roundings and the same order (score descending, then id ascending). The
CUDA kernel is held to the plain version on the card in
``test_torch_cuda.py``.
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
    launches = slot_scan.LAUNCHES
    ts, ti = slot_scan.int8_scan_slots_resident2(*_torch_args(q, codes, scale, mask), slots=slots)
    assert slot_scan.LAUNCHES == launches  # CPU tensors: the plain version
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
@pytest.mark.parametrize("b,n,slots", [(8, 4096, 256), (2048, 1048576, 256), (12, 6144, 128)])
def test_kernel_tiling_covers_columns(b, n, slots, sm_count):
    n_range, n_ranges = slot_scan._kernel_tiling(b, n, slots, sm_count)
    assert n_range % slots == 0
    assert (n_ranges - 1) * n_range < n <= n_ranges * n_range
    assert n_ranges <= 65535  # CUDA grid.y limit


def test_kernel_input_checks_raise():
    q = torch.zeros((8, 128), dtype=torch.int8)
    codes = torch.zeros((4096, 128), dtype=torch.int8)
    scale = torch.ones(4096)
    mask = torch.ones(4096, dtype=torch.bool)
    slot_scan._check_kernel_inputs(q, codes, scale, mask, 256)  # accepted
    bad = [
        (q.float(), codes, scale, mask, 256),  # dtype
        (q, codes[:, :96], scale, mask, 256),  # D disagrees
        (q, codes, scale.double(), mask, 256),
        (q, codes, scale, mask[:100], 256),
        (q, codes, scale, mask, 100),  # slots not a multiple of 32
        (q, codes, scale, mask, 512),  # more slots than threads
        (q, codes[:4000], scale[:4000], mask[:4000], 256),  # N % S
        (q[:, :96], codes[:, :96].contiguous(), scale, mask, 256),  # D % 64
        (q, codes.t().contiguous().t(), scale, mask, 256),  # not contiguous
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            slot_scan._check_kernel_inputs(*args)

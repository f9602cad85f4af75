"""Tests of the port that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is False. This file imports no jax, so it
also runs on a machine without it; there ``tests/conftest.py`` (which
imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nucliadb_tpu_torch.ops import slot_scan
from torch_test_helpers import CASES, assert_same_results

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.parametrize("slots", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, slots):
    """Bit-identical tables, scores and ids, and one counted launch."""
    _need_card()
    arrays = CASES[case](np.random.default_rng(12), slots)
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]
    launches = slot_scan.LAUNCHES
    ks, ki = slot_scan.int8_scan_slots_resident2(*args, slots=slots)
    assert slot_scan.LAUNCHES == launches + 1
    rs, ri = slot_scan.int8_scan_slots_resident2_reference(*args, slots=slots)
    torch.cuda.synchronize()
    assert torch.equal(ks.view(torch.int32), rs.view(torch.int32))
    assert torch.equal(ki, ri)


def test_cuda_index_matches_cpu_index(tmp_path):
    """The same segments searched through a cuda index (kernel route) and a
    cpu index (plain route): identical candidate tables, so the same ids,
    except that near-tied exact scores may swap (cuBLAS sums in another
    order than the CPU)."""
    _need_card()
    from unittest import mock

    import nucliadb_tpu_torch.index.vector.device as tdevice
    from nucliadb_tpu.types import Seq, SimpleOpenIndex
    from nucliadb_tpu_torch.index.vector import (
        Elem, VectorConfig, VectorSearcher, create_segment,
    )

    rng = np.random.default_rng(13)
    v = rng.standard_normal((3000, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128)
    elems = [Elem(key=f"r{i % 7}/f/{i}", vectors=v[i]) for i in range(3000)]
    # three copies of row 0: the default dedup must keep exactly one of four
    elems += [Elem(key=f"dup/f/{j}", vectors=v[0]) for j in range(3)]
    idx = SimpleOpenIndex(segment_list=[(create_segment(str(tmp_path / "s"), elems, cfg), Seq(1))])
    q = rng.standard_normal((5, 128)).astype(np.float32)
    q[0] = v[0] + 0.01 * q[0]
    with mock.patch.object(tdevice, "EXACT_SCAN_THRESHOLD", 256):
        gpu = VectorSearcher(cfg, idx, device="cuda")
        cpu = VectorSearcher(cfg, idx, device="cpu")
    assert torch.equal(gpu.index.codes.codes.cpu(), cpu.index.codes.codes)
    for dedup in (True, False):
        launches = slot_scan.LAUNCHES
        gs, gi = gpu.index.search(q, 10, with_duplicates=not dedup)
        assert slot_scan.LAUNCHES == launches + 1
        cs, ci = cpu.index.search(q, 10, with_duplicates=not dedup)
        assert_same_results(cs, ci, gs, gi)
        top = {gpu.index.keys[i] for i in gi[0]}
        n_dup = len(top & {"r0/f/0", "dup/f/0", "dup/f/1", "dup/f/2"})
        assert n_dup == (1 if dedup else 4)

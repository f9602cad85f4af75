"""The port never imports jax, and never moves a CUDA request to the CPU.

``tests/conftest.py`` imports jax into the test process, so the import
check runs in a fresh interpreter.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import sys, tempfile
    import numpy as np
    import nucliadb_tpu_torch
    import nucliadb_tpu_torch.utils.kernels
    from nucliadb_tpu_torch.index.vector import (
        Elem, VectorConfig, VectorSearcher, VectorSearchRequest, create_segment,
    )
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.ops import binary_scan, distance, quant, slot_scan, topk
    from nucliadb_tpu.types import Seq, SimpleOpenIndex

    rng = np.random.default_rng(0)
    v = rng.standard_normal((40, 16)).astype(np.float32)
    cfg = VectorConfig(dimension=16)
    with tempfile.TemporaryDirectory() as d:
        meta = create_segment(d + "/s", [Elem(key=f"r/{i}", vectors=v[i]) for i in range(40)], cfg)
        searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")
        hits = searcher.search(VectorSearchRequest(vectors=v[7], top_k=3))
    assert hits[0][0].key == "r/7", hits

    # binary codes + "pallas": the popcount slot scan's plain version
    device.EXACT_SCAN_THRESHOLD = 256
    slot_scan.SLOTS, binary_scan.BINARY_BLOCK_N = 256, 512
    v = rng.standard_normal((1500, 128)).astype(np.float32)
    cfg = VectorConfig(dimension=128, quantization="binary", flags=["pallas"])
    with tempfile.TemporaryDirectory() as d:
        meta = create_segment(d + "/s", [Elem(key=f"r/{i:04d}", vectors=v[i]) for i in range(1500)], cfg)
        searcher = VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cpu")
        calls = []
        real = binary_scan.binary_scan_slots
        binary_scan.binary_scan_slots = lambda *a, **k: calls.append(1) or real(*a, **k)
        hits = searcher.search(VectorSearchRequest(vectors=v[[7, 900]], top_k=3))
    assert isinstance(searcher.index.codes, quant.BinaryCodes) and calls == [1], calls
    assert [h[0].key for h in hits] == ["r/0007", "r/0900"], hits
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
    assert not loaded, loaded
    print("OK")
    """
)


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_cuda_request_without_a_card_raises(tmp_path):
    from nucliadb_tpu.types import Seq, SimpleOpenIndex
    from nucliadb_tpu_torch.index.vector import Elem, VectorConfig, VectorSearcher, create_segment
    from nucliadb_tpu_torch.utils.platform import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda index is valid here")
    cfg = VectorConfig(dimension=8)
    v = np.ones((1, 8), np.float32)
    meta = create_segment(str(tmp_path / "s"), [Elem(key="r/0", vectors=v)], cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        VectorSearcher(cfg, SimpleOpenIndex(segment_list=[(meta, Seq(1))]), device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")

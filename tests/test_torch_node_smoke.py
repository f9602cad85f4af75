"""A rehearsal of ``chip_smoke.phase_node`` on the CPU at a small size.

The node phase's whole control flow (indexing, the merge rounds, sync,
hybrid requests on both keyword routes held to the oracles, the filters,
the threaded burst, deletion, the delta against a fresh searcher) runs with
``device="cpu"``, where the wrappers take their plain versions. The
constants that route a full-size shard are shrunk so 2,000 paragraphs take
the same routes: the int8 codes (no host exact tier) and a paragraph group
of its own that the delta reuses.
"""

import chip_smoke


def test_phase_node_rehearsal(tmp_path, monkeypatch, capsys):
    import torch

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as device

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    cfg = dict(chip_smoke.NODE_FULL, resources=40, paragraphs=50, dim=64, hybrid=8, threaded=16, delta=4, cpu=0)
    counts = chip_smoke.phase_node(torch, str(tmp_path), cfg, device="cpu")
    out = capsys.readouterr().out
    assert "node build: 40 resources x 50 paragraphs" in out and "node requests:" in out and "node timings" in out
    # the device route dispatched the BM25 program for every keyword leg
    assert counts.device.get("single", 0) + counts.device.get("batch", 0) >= 8
    assert "NDBTPU_TEXT_HOST_TIER" not in __import__("os").environ

"""A rehearsal of ``chip_smoke.phase_find`` on the CPU at a small size.

The /find phase's whole control flow (ingest through the Processor, the
merge rounds, sync, hybrid /find on both keyword routes held to the BM25
oracle and to a plain RRF, semantic-only recall, the label and security
oracles, the threaded burst) runs with ``device="cpu"``, where the wrappers
take their plain versions. The constants that route a full-size shard are
shrunk so 2,000 paragraphs take the same routes: the int8 codes (no host
exact tier) and a paragraph group of their own.
"""

import chip_smoke


def test_phase_find_rehearsal(tmp_path, monkeypatch, capsys):
    import torch

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as device

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    cfg = dict(chip_smoke.FIND_FULL, resources=40, paragraphs=50, dim=64, requests=12, filtered=4, secured=4,
               fusion=6, semantic=12)
    counts = chip_smoke.phase_find(torch, str(tmp_path), cfg, device="cpu")
    out = capsys.readouterr().out
    assert "find build: 40 resources x 50 paragraphs" in out and "find requests:" in out and "find timings" in out
    # the device route dispatched the BM25 program for every paragraph leg
    assert counts.device.get("single", 0) + counts.device.get("batch", 0) >= 12
    assert "NDBTPU_TEXT_HOST_TIER" not in __import__("os").environ

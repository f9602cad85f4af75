"""Rehearsals of ``chip_smoke.phase_multi`` and ``chip_smoke.phase_paged``
on the CPU at a small size.

The multivector phase's whole control flow runs with ``device="cpu"``: the
ColBERT-shaped corpus with its planted block copies, two segments and a
deletion, the counted MaxSim batch, single vectors, label filter, dedup and
floor held to the float64 oracle, and the knowledge box whose multivector
vectorset answers /find (600 paragraphs of 4-20 tokens, D = 32). The paged
phase reopens a 20,000 x 128 slice corpus under two budgets scaled to it:
host_rerank over the top-2 slot scan's plain version (each call counted
as the kernel's launch would be), then stream in 6 chunks.
"""

import chip_smoke


def test_phase_multi_rehearsal(tmp_path, capsys):
    import torch

    cfg = dict(chip_smoke.MULTI_FULL, paragraphs=600, tokens=(4, 20), dim=32, query_tokens=4,
               kb_resources=5, kb_paragraphs=4, kb_tokens=(2, 5), finds=4)
    out = chip_smoke.phase_multi(torch, str(tmp_path), cfg, device="cpu")
    text = capsys.readouterr().out
    assert "multi index: 600 paragraphs" in text and "multi find: 5 resources" in text
    assert out["m_max"] == 24 and out["p_pad"] == 4096 and out["find"]["paragraphs"] == 20
    assert out["find"]["m_max"] == 6


def test_phase_paged_rehearsal(tmp_path, monkeypatch, capsys):
    import torch

    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.index.vector import VectorConfig, VectorSearcher, VectorSearchRequest
    from nucliadb_tpu_torch.ops import binary_scan, slot_scan

    for name, value in (("N_ROWS", 20_000), ("DIM", 128), ("BATCH", 256), ("ORACLE_QUERIES", 128),
                        ("DELETED", "r000123/"), ("PAGED_BUDGETS", {"host_rerank": 8 << 20, "stream": 2 << 20})):
        monkeypatch.setattr(chip_smoke, name, value)
    corpus = chip_smoke.Corpus(torch, str(tmp_path), device="cpu")
    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 256)
    resident = VectorSearcher(VectorConfig(dimension=128), corpus.open_index, device="cpu")
    assert resident.index.codes is not None
    alive = torch.from_numpy(resident.index.alive)
    corpus.oracle = chip_smoke.exact_oracle(torch, corpus.vecs, alive, corpus.queries[:128], chip_smoke.TOP_K)
    hits = resident.search(VectorSearchRequest(vectors=corpus.q_np, top_k=chip_smoke.TOP_K))
    corpus.resident_int8 = {"recall": chip_smoke.recall_at_k(hits[:128], corpus.oracle), "ms": 1.0}
    real = slot_scan.int8_scan_slots_resident2

    def counted(*args, **kwargs):  # the plain version on the CPU: count what the kernel would
        slot_scan.LAUNCHES.add("top2")
        return real(*args, **kwargs)

    monkeypatch.setattr(slot_scan, "int8_scan_slots_resident2", counted)
    launches, bm25_launches = chip_smoke.phase_paged(torch, slot_scan, binary_scan, corpus, device="cpu")
    text = capsys.readouterr().out
    assert launches >= 4 and bm25_launches == 0 and "paged host_rerank:" in text and "paged stream:" in text and "6 chunks of 4096" in text

"""A rehearsal of ``chip_smoke.phase_mesh`` on the CPU at a small size.

The mesh phase's whole control flow runs with ``device="cpu"`` over a
20,000 x 128 slice corpus (4 segments of 5,000 rows and a deletion, the
exact-scan threshold lowered so each shard takes the int8 route and the
top-2 slot scan's plain version, each call counted as the kernel's launch
would be): the vector group on a 4-member mesh against the sequential
searches, the uneven group, the sharded index exact and int8, the keyword
group, the sharded keyword and hybrid indexes over 4 x 2,000 paragraphs,
and ``search_multi``'s mesh branch over a node's 4 shards on both keyword
routes.
"""

import chip_smoke


def test_phase_mesh_rehearsal(tmp_path, monkeypatch, capsys):
    import torch

    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.ops import slot_scan

    for name, value in (("N_ROWS", 20_000), ("DIM", 128), ("BATCH", 256), ("ORACLE_QUERIES", 128),
                        ("DELETED", "r000123/")):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 256)
    corpus = chip_smoke.Corpus(torch, str(tmp_path), device="cpu")
    alive = torch.ones(20_000, dtype=torch.bool)
    alive[1230:1240] = False  # the deleted resource r000123
    corpus.oracle = chip_smoke.exact_oracle(torch, corpus.vecs, alive, corpus.queries[:128], chip_smoke.TOP_K)
    real = slot_scan.int8_scan_slots_resident2

    def counted(*args, **kwargs):  # the plain version on the CPU: count what the kernel would
        slot_scan.LAUNCHES.add("top2")
        return real(*args, **kwargs)

    monkeypatch.setattr(slot_scan, "int8_scan_slots_resident2", counted)
    cfg = dict(chip_smoke.MESH_FULL, batches=(64, 256), kw_paragraphs=2_000, kw_requests=8, kw_engine_queries=4,
               hybrid_batch=16, node_resources=8, node_threshold=256, node_requests=4)
    launches, bm25_launches, merge_launches, arena_err = chip_smoke.phase_mesh(torch, slot_scan, corpus,
                                                                             str(tmp_path), cfg, device="cpu")
    text = capsys.readouterr().out
    # the CPU runs the plain versions
    assert launches == 8 and bm25_launches == 0 and merge_launches == 0 and arena_err is None
    for line in ("mesh group: 4 shards of 5000 x 128", "mesh uneven group:", "mesh sharded index:",
                 "mesh keyword: 4 shards of 2000", "mesh serving: 8 resources", "mesh numbers:"):
        assert line in text, line

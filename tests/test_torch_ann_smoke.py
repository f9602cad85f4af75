"""A rehearsal of ``chip_smoke.phase_ann`` on the CPU at a small size.

The ANN phase's whole control flow runs with ``device="cpu"``: the graph
built at create and opened without a build, the counted walks and their
recall, the 30 % (walk) and 5 % (scan) label filters, the dedup, the CPU
searcher's agreement, two stitched segments, the IVF segment (k-means at
create, none at open), and a node shard flagged hnsw (indexing, merges,
sync, hybrid requests held to the vector and BM25 oracles), at 3,000 rows
of D = 64.
"""

import chip_smoke


def test_phase_ann_rehearsal(tmp_path, capsys):
    import torch

    node = dict(chip_smoke.ANN_FULL["node"], resources=10, paragraphs=20, dim=64, hybrid=4, threaded=4)
    cfg = dict(chip_smoke.ANN_FULL, rows=3000, dim=64, queries=128, node=node)
    out = chip_smoke.phase_ann(torch, str(tmp_path), cfg, device="cpu")
    text = capsys.readouterr().out
    assert "ann hnsw: 3000 x 64 on cpu" in text and "ann ivf:" in text and "ann node:" in text
    assert out["hnsw"]["recall"] >= chip_smoke.RECALL_BAR and out["stitched"]["recall"] >= chip_smoke.ANN_STITCHED_BAR
    assert out["hnsw"]["trips_per_walk"] >= out["hnsw"]["min_trips"]
    assert out["node"]["walks"] >= 4 and out["node"]["graph_builds_indexing"] == 10
    assert 0.0 <= out["ivf"]["recall"] <= 1.0 and out["ivf"]["clusters"] == 64


def test_ann_phase_child_runner(tmp_path, monkeypatch, capsys):
    """``main`` runs the ANN phase in a child interpreter beside the /find
    phase: the child's command calls ``phase_ann`` at ``ANN_FULL`` in the
    given directory, its lines print when it ends and its numbers come
    back."""
    import subprocess
    import sys

    seen, real_popen = [], subprocess.Popen

    def popen(cmd, **kw):
        seen.append(cmd)
        body = 'print("ann hnsw: stub"); print(\'ann counts: {"phase_s": 1.5}\')'
        return real_popen([sys.executable, "-c", body], **kw)

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", popen)
    call = f"phase_ann(torch, {str(tmp_path)!r}, chip_smoke.ANN_FULL)"
    out = chip_smoke.child_phase_wait(*chip_smoke.child_phase_start(str(tmp_path), "ann", call, "out"), "ann")
    assert f"chip_smoke.{call}" in seen[0][2] and out == {"phase_s": 1.5}
    assert "ann hnsw: stub" in capsys.readouterr().out

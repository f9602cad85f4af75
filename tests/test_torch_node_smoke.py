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


def test_node_phase_child_runner(tmp_path, monkeypatch, capsys):
    """``main`` runs the node phase in a child interpreter beside the /find
    phase: the child's command calls ``phase_node`` at ``NODE_FULL`` in the
    given directory, its lines are printed when it ends, its counts come
    back, and a failed child fails the run."""
    import subprocess
    import sys

    import pytest

    seen, real_popen = [], subprocess.Popen

    def stub(exit_code):
        def popen(cmd, **kw):
            seen.append(cmd)
            body = 'print("node build: stub"); print(\'node counts: {"default": {"top2": 64}, "device": {}}\')'
            return real_popen([sys.executable, "-c", f"{body}; raise SystemExit({exit_code})"], **kw)

        return popen

    monkeypatch.setattr(chip_smoke.subprocess, "Popen", stub(0))
    out = chip_smoke.node_phase_wait(*chip_smoke.node_phase_start(str(tmp_path)))
    cmd = seen[0]
    assert cmd[0] == sys.executable and cmd[1] == "-c"
    assert f"chip_smoke.phase_node(torch, {str(tmp_path)!r}, chip_smoke.NODE_FULL)" in cmd[2]
    assert out.default == {"top2": 64} and out.device == {}
    assert "node build: stub" in capsys.readouterr().out
    monkeypatch.setattr(chip_smoke.subprocess, "Popen", stub(1))
    with pytest.raises(SystemExit, match="the node phase failed"):
        chip_smoke.node_phase_wait(*chip_smoke.node_phase_start(str(tmp_path)))

"""A rehearsal of ``chip_smoke.phase_cluster`` on the CPU at a small size.

``phase_find`` builds its knowledge box at a small size; then the cluster
phase's whole control flow runs over the same files with ``--device
cpu``: a substrate process over them, a writer/ingest/scheduler/worker
process and two searcher replicas, each a process of the port's component
runner with the routing constants shrunk; the hybrid requests through
``DistributedSearcher`` held to the in-process node and the exact oracle,
the protobuf wire, the client threads, the primary killed mid-burst and a
write through the writer plane. Each replica counts its calls of the top-2
scan's plain version as the kernel's launches.
"""

import chip_smoke
from tests.torch_test_helpers import rehearse_phase_cluster


def test_phase_cluster_rehearsal(tmp_path, monkeypatch, capsys):
    out = rehearse_phase_cluster(chip_smoke, tmp_path, monkeypatch, "cpu")
    text = capsys.readouterr().out
    assert "cluster requests: substrate process" in text and "a write the top hit" in text
    assert "every request answered with the same answers" in text
    assert out.timings["write_visible_s"] < 60 and set(out.timings["boot_s"]) == {"s", "w", "c1", "c2"}
    # each replica counts its plain top-2 scans: the primary answered every
    # vector leg, the other none until it took over
    assert "cluster boot: ports open after" in text
    assert out.launches["top2"] >= 12 and out.idle["top2"] == 0
    assert out.took_over["top2"] > 0 and out.started_after > 0

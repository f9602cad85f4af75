"""A rehearsal of ``chip_smoke.phase_http`` on the CPU at a small size.

``phase_find`` builds its knowledge box at a small size, then the HTTP
phase's whole control flow runs over the same directory with
``device="cpu"``: boot A (default keyword route) with its counted requests
held to the in-process answers, the timings and the 32 keep-alive clients;
boot B (device route) as a restart, the writes and the deletion over HTTP;
the CLI as a subprocess, its /find equal to B's, its ``/metrics`` and a
clean exit on SIGTERM. The constants that route a full-size shard are
shrunk, in this process and in the CLI's, so 2,000 paragraphs take the
same routes.
"""

import chip_smoke
from tests.torch_test_helpers import rehearse_phase_http


def test_phase_http_rehearsal(tmp_path, monkeypatch, capsys):
    counts = rehearse_phase_http(chip_smoke, tmp_path, monkeypatch, "cpu")
    out = capsys.readouterr().out
    assert "http requests: 12 hybrid /find over HTTP" in out and "http timings" in out
    assert "its /find equal to boot B's, exited on SIGTERM" in out
    # the device route dispatched the BM25 program for every paragraph leg
    assert counts.device.get("single", 0) + counts.device.get("batch", 0) >= 12
    assert "NDBTPU_TEXT_HOST_TIER" not in __import__("os").environ

"""A rehearsal of ``chip_smoke.phase_ops`` on the CPU at a small size.

``phase_find`` builds its knowledge box at a small size and the boot
migrations are applied; then the ops phase's whole control flow runs over
the same files with ``--device cpu``: the ops tool's ``list-kbs`` and
``shards`` and the migrator's dry run as subprocesses; the server booted
with spans exported to an OTLP sink, the SDK's ``/find`` answers held to
raw ``httpx``'s and the sink's spans decoded; a node whose segments come
through the port's S3 storage from the SigV4-checking fake, held to a node
over the local files. The top-2 scan's plain calls count as its launches.
Where the OpenTelemetry SDK imports (``tracing._OTEL``, set here for the
second case), the phase attaches the port's exporter to the built-in tracer
itself and restores the tracer after.
"""

import pytest

import chip_smoke
from tests.torch_test_helpers import rehearse_phase_ops


@pytest.mark.parametrize("otel_sdk", [False, True])
def test_phase_ops_rehearsal(otel_sdk, tmp_path, monkeypatch, capsys):
    from nucliadb_tpu_torch.telemetry import tracing

    monkeypatch.setattr(tracing, "_OTEL", otel_sdk)
    out = rehearse_phase_ops(chip_smoke, tmp_path, monkeypatch, "cpu", budget_s=300.0)
    text = capsys.readouterr().out
    assert ("attached by the phase" in text) == otel_sdk and tracing._tracer is None
    assert "the migrator's dry run lists nothing pending" in text
    assert "8 NucliaDBClient.find answers equal raw httpx's" in text
    assert "16 search.find spans with their kbid" in text and out.spans == 16
    assert "8 hybrid requests equal the local node's" in text
    # one top-2 scan a request on each counted pass
    assert out.sdk["top2"] == 8 and out.s3["top2"] == 8 and out.launches["top2"] == 16
    assert out.served["gets"] > 0 and out.served["refused"] == 0 and out.served["get_bytes"] > 0

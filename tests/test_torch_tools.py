"""The port's measurement tools (``nucliadb_tpu_torch/tools``) run only on
a card, but what they build is plain text: every design variant of the
int8 slot scan must still apply to the kernel's source (a variant whose
anchor no longer matches would time the wrong kernel), and the wgmma rate
probe must generate a kernel for each case it times."""

import re

import pytest

from nucliadb_tpu_torch.tools import slot_scan_variants, wgmma_rate
from nucliadb_tpu_torch.utils import kernels

_SOURCE = (kernels.CSRC / "int8_slot_scan.cu").read_text()
_VARIANTS = slot_scan_variants.variants(_SOURCE)


def test_base_variant_is_the_kernel():
    assert _VARIANTS["base"] == _SOURCE
    assert set(slot_scan_variants.INEXACT) <= set(_VARIANTS)


@pytest.mark.parametrize("name", sorted(set(_VARIANTS) - {"base"}))
def test_each_variant_changes_the_kernel_and_keeps_its_entry(name):
    text = _VARIANTS[name]
    assert text != _SOURCE
    assert 'extern "C" int int8_slot_scan(' in text  # launched through the same C entry
    assert text.count("{") == text.count("}")  # balanced, so nvcc sees whole blocks


def test_phase_variants_export_their_reader():
    for name in ("phases", "prefetch_phases"):
        assert 'extern "C" int read_phases(' in _VARIANTS[name]
        assert len(re.findall(r"ph\[\d\] \+= tq - tp", _VARIANTS[name])) == 4
    assert len(slot_scan_variants.PHASE_NAMES) == 4


def test_wgmma_rate_source_has_every_case():
    src = wgmma_rate.source()
    for n, _ in wgmma_rate.CASES:
        assert f"m64n{n}k32.s32.s8.s8" in src
        assert f"k = rate<{n}>;" in src
    for entry in ("run", "run_contend", "run_handoff"):
        assert f'extern "C" int {entry}(' in src
    assert src.count("{") == src.count("}")
    # every case does the same work, in whole iterations
    for n, wgs in wgmma_rate.CASES:
        assert wgmma_rate.MACS_PER_SM % (64 * n * 32 * 4 * wgs) == 0


@pytest.mark.parametrize("path", ["node", "find"])
def test_burst_profile_runs_on_the_cpu(monkeypatch, capsys, path):
    """The burst probe's whole flow at a small size on the CPU (the int8
    threshold and text group size lowered as in the node phase's
    rehearsal): every setting timed on both routes with its payload
    parses, a profile and a sampled burst."""
    import json

    import nucliadb_tpu_torch.index.text_engine.engine as engine
    import nucliadb_tpu_torch.index.vector.device as device
    from nucliadb_tpu_torch.tools import burst_profile

    monkeypatch.setattr(device, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(device, "HOST_SCAN_ELEMS", 0)
    monkeypatch.setattr(engine, "GROUP_MIN_DOCS", 1_000)
    monkeypatch.delenv("NDBTPU_TEXT_HOST_TIER", raising=False)
    burst_profile.main(["--path", path, "--resources", "12", "--paragraphs", "50", "--requests", "8", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    times = [x for x in lines if "times" in x]
    assert [x["route"] for x in times] == ["device", "default"]
    settings = burst_profile.SETTINGS if path == "node" else ("served",)
    assert all(set(x["times"]) == set(settings) for x in times)
    parses = [p for x in times for t in x["times"].values() for _, p in t["payload_parses"]]
    # four passes a setting; the node path parses no payload (at this size
    # the /find path's payloads may all sit in the Processor's 2 s cache)
    assert len(parses) == 4 * len(settings) * 2 and all(p >= 0 for p in parses)
    assert path == "find" or not any(parses)
    assert sum("profiled_burst" in x for x in lines) == 2 and sum("frames" in x for x in lines) == 2
    assert __import__("sys").getswitchinterval() == 0.005

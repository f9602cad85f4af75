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

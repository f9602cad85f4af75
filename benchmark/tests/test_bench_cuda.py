"""The comparison on the card, at a size a test run holds: the control (the
plain reference in TF32 in the program's place) has to come out as not
correct, and the port's int8 route as correct. Run on the card with

    python -m pytest -m cuda benchmark/tests/test_bench_cuda.py
"""

import pytest
import torch

from benchmark import check, harness
from benchmark.control import control_numbers
from benchmark.generator import Traffic

CELL = "semantic-768d-1m.batch2048"


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")


def _small(rows):
    config = harness.load_config(harness.find_cell(harness.load_spec(), CELL)[1])
    config["rows"] = rows
    traffic = Traffic.from_dict(dict(
        entry="searcher", clients=1, batch=256, top_k=10, filtered=False,
        pool=65536, sample_every=16, warmup={"batches": [], "requests": 2},
    ))
    return config, traffic


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 2**31 + 7, 2**33 + 1])
def test_control_is_not_correct(seed):
    _needs_card()
    config, traffic = _small(200_000)
    numbers = control_numbers(config, traffic, seed, 1024, torch.device("cuda"))
    correct, checks = check.judge(numbers, config["limits"])
    assert not correct and checks["score_err"]["value"] > checks["score_err"]["limit"], checks


@pytest.mark.cuda
def test_program_is_correct():
    _needs_card()
    config, traffic = _small(200_000)  # above the port's exact-scan threshold: the int8 route
    run, line = harness.run_cell(CELL, 2**31 + 3, 2.0, True, "cuda", config=config, traffic=traffic)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["busy_s"] > 0
    assert {"scan.kernel_ms", "int8_slot_scan_roofline", "rerank_cut.device_ms"} <= set(line["metrics"])
    assert 0 < line["metrics"]["int8_slot_scan_roofline"]["value"] <= 100

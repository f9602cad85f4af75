"""Small sizes for the benchmark's CPU tests: a 6,000-row corpus of width
128 that still takes the int8 route (the port's exact-scan threshold and
host tier lowered, as the port's own node tests do)."""

import pytest

from benchmark import harness
from benchmark.generator import Traffic

TINY_ROWS = 6000
TINY_DIM = 128
TRAFFIC = {
    "batch2048": dict(entry="searcher", clients=1, batch=64, top_k=10, filtered=False,
                      pool=8192, sample_every=16, warmup={"batches": [], "requests": 2}),
    "clients32": dict(entry="coalescer", clients=6, batch=1, top_k=10, filtered=False,
                      pool=8192, sample_every=4, warmup={"batches": [1, 2, 4, 8], "requests": 2}),
    # no cell of BENCHMARK.json sends filtered queries yet (PERF.md, Open
    # questions): the client cell runs them, to hold the check to the filter
    "filtered": dict(entry="coalescer", clients=4, batch=1, top_k=10, filtered=True,
                     pool=4096, sample_every=4, warmup={"batches": [1], "requests": 2}),
}
CELLS = {
    "batch2048": "semantic-768d-1m.batch2048",
    "clients32": "semantic-768d-1m.clients32",
    "filtered": "semantic-768d-1m.clients32",
}


@pytest.fixture
def tiny(monkeypatch):
    """``run(mix, **kw)``: one CPU run of the mix's cell at the small size."""
    import nucliadb_tpu_torch.index.vector.device as device_mod

    monkeypatch.setattr(device_mod, "EXACT_SCAN_THRESHOLD", 256)
    monkeypatch.setattr(device_mod, "HOST_SCAN_ELEMS", 0)

    def run(mix, seed=2**31 + 12345, seconds=0.6, trace=False, traffic=None):
        cell = CELLS[mix]
        config = harness.load_config(harness.find_cell(harness.load_spec(), cell)[1])
        config.update(rows=TINY_ROWS, dimension=TINY_DIM)
        t = Traffic.from_dict(dict(TRAFFIC[mix], **(traffic or {})))
        return harness.run_cell(cell, seed, seconds, trace, "cpu", config=config, traffic=t)

    return run

"""Whole runs of the harness on the CPU at a small size: the result line's
schema, a traced run, the timed path broken underneath (``correct`` has to
come out false), and the command's refusals."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
E2E = {"qps", "p50_ms", "recall_at_10", "setup_s"}


@pytest.mark.parametrize("mix", ["batch2048", "clients32", "filtered"])
def test_cell_runs_correct(tiny, mix):
    run, line = tiny(mix)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == E2E
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert run.numbers["compared"] > 0 and run.window.repeated == 0
    assert all(set(c) == {"value", "limit", "bound"} for c in line["checks"].values())
    json.dumps(line)


def test_a_window_past_its_pool_is_not_correct(tiny):
    """A window that takes more queries than its pool holds repeats them,
    and a cache of results could then answer them: the run is not
    correct, and its other numbers still hold."""
    run, line = tiny("batch2048", traffic={"pool": 256, "sample_every": 4}, seconds=1.0)
    assert run.window.repeated > 0 and line["correct"] is False
    assert line["checks"]["repeated_queries"]["value"] == run.window.repeated
    assert all(c["value"] <= c["limit"] for n, c in line["checks"].items() if c["bound"] == "max" and n != "repeated_queries")


@pytest.mark.parametrize("mix", ["batch2048", "clients32"])
def test_traced_run(tiny, mix):
    run, line = tiny(mix, trace=True, seconds=1.0)
    assert line["correct"] is True
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: only the host's per-layer metrics read
    want = {"searcher.host_ms", "device_index.ms"} | ({"coalescer.queries_per_dispatch"} if mix == "clients32" else set())
    assert set(line["metrics"]) == want
    assert line["device"]["window_s"] > 0 and run.take is not None
    assert {s.name for s in run.spans} >= {"searcher.search", "device_index.search"}
    lines = harness.report(run)
    assert any(t.startswith("take ") for t in lines) and any("garbage collections" in t for t in lines)
    assert any(t.startswith("host: probe_ms_before") for t in lines)


def _broken(monkeypatch, fault):
    """Break ``DeviceVectorIndex.search`` underneath the timed path, from
    the window's opening on (the warm-up meets the real one)."""
    from nucliadb_tpu_torch.index.vector.device import DeviceVectorIndex

    from benchmark.generator import Load

    search, open_window = DeviceVectorIndex.search, Load.run
    armed = []

    def broken(self, queries, top_k, **kw):
        scores, ids = search(self, queries, top_k, **kw)
        if not armed:
            return scores, ids
        scores, ids = scores.copy(), ids.copy()
        if fault == "score_altered":
            scores[:, 0] += 1e-3
        elif fault == "key_altered":
            ids[:, 0] = (ids[:, 0] + 1) % self.n_para
        elif fault == "deleted_returned":
            ids[:, -1] = 375  # a paragraph of resource 37, deleted
        elif fault == "half_batch_dropped":
            ids[ids.shape[0] // 2 :] = -1
        elif fault == "raises":
            raise RuntimeError("a broken dispatch")
        return scores, ids

    def run(self, *a, **k):
        armed.append(True)
        return open_window(self, *a, **k)

    monkeypatch.setattr(DeviceVectorIndex, "search", broken)
    monkeypatch.setattr(Load, "run", run)


@pytest.mark.parametrize(
    "mix, fault, fails",
    [
        ("batch2048", "score_altered", "score_err"),
        ("batch2048", "key_altered", "score_err"),
        ("batch2048", "deleted_returned", "ineligible_hits"),
        ("batch2048", "half_batch_dropped", "malformed_answers"),
        ("clients32", "score_altered", "score_err"),
        ("clients32", "raises", "failed"),
        ("filtered", "key_altered", "ineligible_hits"),
    ],
)
def test_broken_path_is_not_correct(tiny, monkeypatch, mix, fault, fails):
    _broken(monkeypatch, fault)
    run, line = tiny(mix)
    assert line["correct"] is False
    c = line["checks"][fails]
    assert (c["value"] < c["limit"]) if c["bound"] == "min" else (c["value"] > c["limit"])


def test_same_seed_same_sample_and_answers(tiny):
    a, _ = tiny("batch2048", seed=77)
    b, _ = tiny("batch2048", seed=77)
    common = sorted(set(a.window.answers) & set(b.window.answers))
    assert common and all(a.window.answers[i] == b.window.answers[i] for i in common)


def _command(args, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True, timeout=120
    )


def test_command_refuses_without_a_card():
    out = _command(["--workload", "semantic-768d-1m.batch2048", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode == 2 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_command_refuses_an_unknown_workload():
    out = _command(["--workload", "nope", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert out.returncode != 0 and out.stdout == "" and "no workload" in out.stderr


def test_no_jax_module_after_a_run():
    """In a fresh interpreter: a small run on the CPU, then no loaded
    module's top-level name is jax, jaxlib, flax or nucliadb_tpu (the
    port's ``nucliadb_tpu_torch`` is another name)."""
    script = textwrap.dedent(
        """
        import json, sys
        sys.path.insert(0, sys.argv[1])
        import nucliadb_tpu_torch.index.vector.device as device_mod
        device_mod.EXACT_SCAN_THRESHOLD = 256
        device_mod.HOST_SCAN_ELEMS = 0
        from benchmark import harness
        from benchmark.generator import Traffic
        from benchmark.tests.conftest import TINY_DIM, TINY_ROWS, TRAFFIC
        cell = "semantic-768d-1m.clients32"
        config = harness.load_config(harness.find_cell(harness.load_spec(), cell)[1])
        config.update(rows=TINY_ROWS, dimension=TINY_DIM)
        run, line = harness.run_cell(cell, 5, 0.3, True, "cpu", config=config,
                                     traffic=Traffic.from_dict(TRAFFIC["clients32"]))
        tops = sorted({m.split(".", 1)[0] for m in sys.modules})
        print(json.dumps({"correct": line["correct"], "forbidden": harness.forbidden_modules(), "tops": tops}))
        """
    )
    out = subprocess.run([sys.executable, "-c", script, str(ROOT)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["forbidden"] == []
    assert "nucliadb_tpu_torch" in got["tops"] and not {"jax", "jaxlib", "flax", "nucliadb_tpu"} & set(got["tops"])


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nucliadb_tpu_native_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nucliadb_tpu.fake", object())
    assert harness.forbidden_modules() == ["nucliadb_tpu.fake"]

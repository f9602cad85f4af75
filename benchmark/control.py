"""The control of a cell's comparison: the plain reference put in the
program's place one precision below the configuration's (float32 products
in TF32), judged by the same comparison as a run. It has to come out as
not correct; its readings set the upper end of the limits.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 --compare 4000

For each seed it answers the first ``--compare`` sampled queries of the
cell's pool (as many as a run compares) and prints one JSON line with the
compared numbers and the verdict. It runs on the card; a run never calls
it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, corpus, harness  # noqa: E402
from benchmark.generator import sample_indices  # noqa: E402
from benchmark.reference import vector as reference  # noqa: E402


def control_numbers(config: dict, traffic, seed: int, compare: int, device) -> dict:
    """The compared numbers of the reference in TF32 in the program's place."""
    n, d = int(config["rows"]), int(config["dimension"])
    sampled = sample_indices(seed, traffic.pool, traffic.sample_every)[:compare]
    pool = corpus.query_pool(seed, d, int(sampled[-1]) + 1, device)
    rows_t = corpus.rows(seed, n, d, device)
    ok_t = torch.from_numpy(check.eligible_rows(config, traffic.filtered)).to(device)
    q = torch.from_numpy(pool[sampled]).to(device)
    ids, scores = reference.exact_topk(rows_t, q, ok_t, traffic.top_k, config["similarity"], tf32=True)
    del rows_t, q, ok_t
    ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
    answers = {
        int(i): ([corpus.key_of(int(r)) for r in ids[j] if r >= 0], [float(s) for s, r in zip(scores[j], ids[j]) if r >= 0])
        for j, i in enumerate(sampled)
    }
    numbers = check.compare(config, seed, traffic.top_k, traffic.filtered, answers, sampled, pool, device)
    numbers["failed"] = numbers["repeated_queries"] = 0
    return numbers


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--compare", type=int, required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: TF32 exists on the card only", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell, config_entry = harness.find_cell(spec, args.workload)
    config = harness.load_config(config_entry)
    traffic = harness.load_traffic(cell["traffic"])
    for seed in args.seeds:
        numbers = control_numbers(config, traffic, seed, args.compare, torch.device("cuda"))
        correct, checks = check.judge(numbers, config["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": correct,
                          "compared": numbers["compared"], "checks": checks}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The comparison that decides ``correct``: the answers a window returned,
held against the plain reference (``benchmark/reference/vector.py``) once
the window has closed and the program's state is freed.

Compared are the answers kept for the sampled queries (one in
``sample_every`` of the pool, drawn from the seed) that fell due in the
window, up to ``MAX_COMPARED`` of them, as the entry returned them to the
caller: keys and scores. The numbers, each held to a limit of the
configuration's ``limits``:

- ``recall_at_10``: the share of the reference's exact top-10 that the
  first ten hits hold, over the compared queries;
- ``score_err``: the largest gap between a hit's score and the exact
  (float64) similarity of its row with the query;
- ``ineligible_hits``: hits whose key is no row of the corpus, a deleted
  one, or (filtered) one without the label;
- ``malformed_answers``: answers with another number of hits than
  ``top_k``, a key twice, a score that is no finite number, or scores
  out of descending order;
- ``unanswered``: sampled queries that fell due and got no answer;
- ``failed``: queries whose request raised.

This module imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import corpus
from .reference import vector as reference

MAX_COMPARED = 16384


def eligible_rows(config: dict, filtered: bool) -> np.ndarray:
    n = int(config["rows"])
    ok = corpus.alive(n, int(config["delete_every"]))
    if filtered:
        ok &= corpus.labelled(n, int(config["label_every"]))
    return ok


def compare(config: dict, seed: int, top_k: int, filtered: bool, answers: dict, sampled_due: np.ndarray,
            pool: np.ndarray, device) -> dict:
    """The compared numbers of one window. ``answers`` maps pool indices to
    (keys, scores); ``sampled_due`` holds the sampled indices that fell
    due."""
    n, d, sim = int(config["rows"]), int(config["dimension"]), config["similarity"]
    due = [int(i) for i in sampled_due]
    unanswered = sum(1 for i in due if i not in answers)
    compared = [i for i in due if i in answers][:MAX_COMPARED]
    out = {"compared": len(compared), "unanswered": unanswered}
    if not compared:
        out.update(recall_at_10=0.0, score_err=float("inf"), ineligible_hits=0, malformed_answers=0)
        return out
    ok_np = eligible_rows(config, filtered)
    rows_t = corpus.rows(seed, n, d, device)
    ok_t = torch.from_numpy(ok_np).to(device)
    q = torch.from_numpy(pool[compared]).to(device)
    want, _ = reference.exact_topk(rows_t, q, ok_t, max(top_k, 10), sim)
    want = want.cpu().numpy()

    got = np.full((len(compared), top_k), -1, dtype=np.int64)
    scores = np.full((len(compared), top_k), np.nan, dtype=np.float64)
    ineligible = malformed = 0
    recall = []
    for r, i in enumerate(compared):
        keys, s = answers[i]
        rows = [corpus.row_of(k) for k in keys]
        if (
            len(keys) != top_k
            or len(set(keys)) != len(keys)
            or not all(math.isfinite(x) for x in s)
            or any(b > a for a, b in zip(s, s[1:]))
        ):
            malformed += 1
        for j, (row, score) in enumerate(zip(rows[:top_k], s[:top_k])):
            if row < 0 or not ok_np[row]:
                ineligible += 1
                continue
            got[r, j] = row
            scores[r, j] = score
        truth = {int(x) for x in want[r, :10] if x >= 0}
        recall.append(len(truth & set(rows[:10])) / max(1, len(truth)))
    err = 0.0
    for lo in range(0, len(compared), 1024):
        ids = torch.from_numpy(got[lo : lo + 1024]).to(device)
        exact = reference.exact_scores(rows_t, q[lo : lo + 1024], ids, sim).cpu().numpy()
        gap = np.abs(exact - scores[lo : lo + 1024])
        if np.isfinite(gap).any():
            err = max(err, float(np.nanmax(gap)))
    del rows_t, q
    out.update(
        recall_at_10=float(np.mean(recall)), score_err=err,
        ineligible_hits=ineligible, malformed_answers=malformed,
    )
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit (``{"min": x}`` or
    ``{"max": x}``), and whether all hold."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        (kind, bound), = limit.items()
        held = value >= bound if kind == "min" else value <= bound
        ok &= held
        out[name] = {"value": value, "limit": bound, "bound": kind}
    return ok, out

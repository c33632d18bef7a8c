"""The comparison that decides ``correct``: the answers the window kept
against the plain reference's answers to the same queries.

Every number compared has a limit; a run is correct when each number is
at most its limit and at least one answer was compared. The program
promises the reference engine's exact answers (doc ids, float32 scores,
total hits), and the readings over a dozen seeds and more (PERF.md) bear
that out, so the limits are 0. The control, the reference computed in
bfloat16, reads far above them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Answer = Tuple[int, Sequence[int], Sequence[float]]

LIMITS = {
    "wrong_answers": 0,  # answers whose hits, doc ids or scores differ
    "score_gap": 0.0,  # widest |score - reference| / reference at a rank
    "failed_queries": 0,  # queries whose call raised
}


def compare(answers: Sequence[Answer],
            expected: Sequence[Answer],
            failed: int) -> Dict[str, float]:
    wrong, gap = 0, 0.0
    for (hits, docs, scores), (r_hits, r_docs, r_scores) in zip(answers, expected):
        if (hits != r_hits or list(docs) != list(r_docs)
                or list(scores) != list(r_scores)):
            wrong += 1
        if len(scores) != len(r_scores):
            gap = max(gap, 1.0)
        for s, r in zip(scores, r_scores):
            gap = max(gap, abs(s - r) / abs(r) if r else abs(s))
    return {"wrong_answers": wrong, "score_gap": gap,
            "failed_queries": failed, "answers_compared": len(answers)}


def verdict(numbers: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in LIMITS.items()}
    checks["answers_compared"] = {"value": numbers["answers_compared"],
                                  "limit": "at least 1"}
    ok = (all(numbers[n] <= lim for n, lim in LIMITS.items())
          and numbers["answers_compared"] >= 1)
    return ok, checks

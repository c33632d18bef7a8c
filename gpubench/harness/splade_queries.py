"""Write the query table of a sparse configuration's traffic file.

    python3 gpubench/harness/splade_queries.py [--config gpubench/configs/msmarco-splade-1.1m.json] [--out gpubench/traffic/splade-dev-b256.json]

from the root of a checkout. The table holds ``dev_queries`` queries,
each a SHOULD list of ``"<WordPiece id>^<weight>"`` clauses in Lucene's
boost syntax, ids ascending. A query's number of non-zeros is log-normal
with the configuration's ``query_nnz_*``; its ids are distinct draws from
the passages' own term law (``sparse_corpus.term_cdf`` and
``wordpiece_of_rank``); its weights are log-normal with the
``query_weight_*`` parameters, written to 4 significant digits (a reader
takes ``np.float32(float(text))``). Everything is drawn in numpy from
``table_seed``, so the table is the same on every machine. The traffic
file's other keys are written as given here.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
sys.path.insert(0, str(HERE))

from harness.sparse_corpus import term_cdf, wordpiece_of_rank  # noqa: E402

TRAFFIC = {
    "name": "splade-dev-b256",
    "mode": "batch",
    "field": "splade",
    "k": 10,
    "table_source": "MS MARCO passage dev small's size, 6,980 queries (Bajaj et al., arXiv:1611.09268); SPLADE query shape, 43 mean non-zeros over BERT's 30,522 WordPieces (Bruch et al., SIGIR 2024, Table 1); drawn by gpubench/harness/splade_queries.py",
    "batch_size": 256,
    "batch_source": "the port's documented sparse serving batch: 256 queries a dispatch_batch call (benchmarks/sparse_bench.py --queries default and its help text; chip_smoke.py phase 9)",
    "pool_calls": 16,
    "warmup_calls": 2,
    "pool_seed": 20261018,
    "kept_share": 1.0,
    "kept_per_call": 4,
    "stretch_calls": 30,
    "loop": "closed, one client, one batch in flight; a batch is the next 256 queries of the table's passes",
    "who": "a SPLADE retrieval service for web questions (MS MARCO's users), whose front end coalesces concurrent users' queries into 256-query calls to each shard's card",
}


def draw_queries(cfg: dict):
    """[(ids int64 ascending, weights f64)] for the table, from table_seed."""
    rng = np.random.Generator(np.random.PCG64(cfg["table_seed"]))
    n = cfg["dev_queries"]
    sigma = cfg["query_nnz_sigma"]
    counts = np.clip(np.round(rng.lognormal(
        np.log(cfg["query_nnz_mean"]) - sigma * sigma / 2, sigma, n)),
        cfg["query_nnz_min"], cfg["query_nnz_max"]).astype(np.int64)
    cdf, wp = term_cdf(cfg), wordpiece_of_rank(cfg)
    out = []
    for c in counts:
        ranks = np.searchsorted(cdf, rng.random(int(np.ceil(
            cfg["draw_factor"] * c)) + 8)).clip(max=len(cdf) - 1)
        _, first = np.unique(ranks, return_index=True)
        ids = np.sort(wp[ranks[np.sort(first)][:c]])
        w = np.clip(rng.lognormal(np.log(cfg["query_weight_median"]),
                                  cfg["query_weight_sigma"], len(ids)),
                    cfg["query_weight_min"], cfg["query_weight_max"])
        out.append((ids, w))
    return out


def table(cfg: dict):
    return [{"should": [f"{int(t)}^{w:.4g}" for t, w in zip(ids, ws)]}
            for ids, ws in draw_queries(cfg)]


def dumps(traffic: dict) -> str:
    """The traffic file's text: a key a line, a query of the table a line."""
    lines = []
    for key, v in traffic.items():
        if key == "table":
            rows = ",\n".join("  " + json.dumps(e, separators=(",", ":"))
                              for e in v)
            lines.append(f' "table": [\n{rows}\n ]')
        else:
            lines.append(f" {json.dumps(key)}: {json.dumps(v)}")
    return "{\n" + ",\n".join(lines) + "\n}\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(
        HERE / "configs" / "msmarco-splade-1.1m.json"))
    ap.add_argument("--out", default=str(
        HERE / "traffic" / "splade-dev-b256.json"))
    args = ap.parse_args(argv)
    cfg = json.loads(Path(args.config).read_text())
    rows = table(cfg)
    nnz = [len(r["should"]) for r in rows]
    traffic = dict(TRAFFIC, table_mean_nnz=float(np.mean(nnz)), table=rows)
    Path(args.out).write_text(dumps(traffic))
    print(f"{len(rows)} queries, mean non-zeros {np.mean(nnz):.3f}, "
          f"min {min(nnz)}, max {max(nnz)} -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of the comparison at a cell's own size: the reference
computed in bfloat16 put in the program's place, over the answers a run
of ``--calls`` calls keeps, judged by the same comparison and limits.
Every seed has to come out not correct.

    python3 gpubench/control.py --workload <name> --calls <n> --seeds <s> [<s> ...]

The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import torch  # noqa: E402

from harness import cell as cells  # noqa: E402
from harness import check  # noqa: E402
from harness.traffic import ORDER_LEN, make_pool  # noqa: E402


def control(cell, seed: int, calls: int, device) -> dict:
    cfg, tr = cell.config, cell.traffic
    # the program stays out of the control's process
    generator, reference = cells.modules(cfg, ("generator", "reference"))
    corpus = generator.make_corpus(cfg, seed, device)
    pool = make_pool(tr, seed)
    specs = []
    for i in range(calls):
        slot = i % ORDER_LEN
        pi = int(pool.order[slot])
        specs += [pool.calls[pi][p] for p in pool.keep[slot]]
    ref = reference.Reference.for_corpus(corpus, pool.field, cfg, device)
    distinct = list(dict.fromkeys(specs))
    low = dict(zip(distinct, ref.answer(distinct, pool.k, "bf16")))
    exact = dict(zip(distinct, ref.answer(distinct, pool.k)))
    numbers = check.compare([low[s] for s in specs], [exact[s] for s in specs], 0)
    ok, checks = check.verdict(numbers)
    return {"workload": cell.name, "seed": seed, "correct": ok, "checks": checks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = cells.load_cell(args.workload)
    failed_to_reject = 0
    for seed in args.seeds:
        t = time.perf_counter()
        r = control(cell, seed, args.calls, torch.device(args.device))
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
        failed_to_reject += r["correct"]
    return 1 if failed_to_reject else 0


if __name__ == "__main__":
    sys.exit(main())

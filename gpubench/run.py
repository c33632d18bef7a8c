"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix and
per-layer metrics are read from ``BENCHMARK.json``. The run needs the
cards the cell asks for: without them it exits with code 2 and prints no
result. The last line of standard output is the result's JSON object;
the numbers compared with the reference, each beside its limit, are the
last lines of standard error.

The run re-executes itself once with ``PYTHONHASHSEED=0``, so the order
of every set and dict of strings, in the harness and in the program, is
the same in every run; its set-up time counts from the first start.
"""

import os
import sys
import time

if os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["GPUBENCH_T0"] = repr(time.time())
    os.execv(sys.executable, [sys.executable] + sys.argv)
T_PROCESS = float(os.environ.pop("GPUBENCH_T0", time.time()))

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import cell as cells

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        cells.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}")
        return 2
    result = cells.execute(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_PROCESS)
    bad = cells.forbidden_modules()
    if bad:
        cells.log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        cells.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

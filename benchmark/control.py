"""The control of the check: whole runs of a cell through the harness with
the program's float fields at the precision below the configuration's f32
(bfloat16) where the timed path takes them in or hands them out
(``benchlib/client.py``), judged by the cell's own check.  Every run must
come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>]

Runs at the cell's own size on the card, one run a seed in one process;
the benchmark's runs do not run it.  Prints one JSON line a seed with
``correct`` and each number beside its limit; exits 1 if a control run
came out correct."""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, ROOT]
    from benchlib import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    passed = 0
    for seed in args.seeds:
        res = harness.run(ROOT, bench, args.workload, seed, args.seconds,
                          False, "cuda", time.perf_counter(),
                          log=lambda s: print("# " + s, flush=True),
                          control=True)
        passed += bool(res["correct"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())

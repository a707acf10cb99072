"""Read the numbers that decide ``correct`` over many seeds in one process,
for the cells whose runner reads them itself (``Runner.readings``:
``fmllr_decode``, ``train_ali``): the program's after a short window at
the cell's own load, with ``--control`` the references' in TF32 in the
program's place, with ``--faults`` each planted fault's.  The limits in
``benchmarks/workloads/<cell>.json`` are set between the program's highest
reading and the lowest reading that fails.

    python benchmarks/vbbench/cell_readings.py --workload <cell> --seeds 1,2,3
        [--seconds 5] [--control] [--faults] [--out FILE]

One JSON line per seed and reading; needs the card.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for entry in (str(BENCH.parent), str(BENCH)):
    if entry not in sys.path:
        sys.path.insert(0, entry)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from vbbench import harness
    from vbbench.record import Run

    harness.cache_env(harness.ROOT)
    if not torch.cuda.is_available():
        print("cell_readings: no card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, config, traffic = harness.load_cell(args.workload)
    mod = importlib.import_module(f"vbbench.runners.{cell['runner']}")
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = Run(workload=args.workload, cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=args.seconds, trace=False, device=torch.device("cuda", 0))
        runner = mod.Runner(run)
        runner.setup()
        setup_s = time.perf_counter() - t0
        runner.window(time.perf_counter() + args.seconds)
        for what, compared in runner.readings(args.control, args.faults):
            rec = {"workload": args.workload, "seed": seed, "reading": what, "failed": run.failed,
                   "attempted": run.attempted, "setup_s": setup_s,
                   "numbers": {c.name: c.value for c in compared}}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
        del runner, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

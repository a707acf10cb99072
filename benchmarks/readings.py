"""Read the numbers that decide ``correct`` over many seeds in one process:
the program's (after a short window at the cell's own load), the
control's (``--control``: the references in TF32 in the program's place)
and, for a training cell, each planted fault's (``--faults``).  The limits
in ``benchmarks/workloads/<cell>.json`` are set between the program's
highest reading and the lowest reading that fails.

    python benchmarks/readings.py --workload <cell> --seeds 1,2,3 [--seconds 5]
        [--control] [--faults] [--out FILE]

One JSON line per seed and reading; needs the card.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for entry in (str(HERE.parent), str(HERE)):
    if entry not in sys.path:
        sys.path.insert(0, entry)


def iteration_faults(runner, it: dict) -> dict:
    """The training faults planted in the outputs of the program's iteration
    ``it`` (``Runner.outputs``): the model left as it started, the E-step
    over half of the utterances doubled, one state of the longest utterance
    entered a frame late."""
    import numpy as np
    import torch

    from vbbench import faults, models
    from voicebridge_tpu_torch.steps import train_tri

    out = {"state_unchanged": {**it, "model": it["start_gmm"],
                               "log_probs": it["start_log_probs"]}}
    half = it["weights"].copy()
    half[len(half) // 2:] = 0.0
    stats = train_tri.e_step(models.to_am(it["start_gmm"]), runner.tm, runner.x, it["tids"], half)
    out["half_batch"] = {**it, "stats": [2 * np.asarray(s) for s in stats[:4]]}
    tids = it["tids"].copy()
    u = int(np.argmax(runner.nf))
    faults.delay_entry(tids[u], int(runner.nf[u]))
    out["answer_altered"] = {**it, "tids": tids}
    del stats
    torch.cuda.empty_cache()
    return out


def read_seed(cell: dict, config: dict, traffic: dict, name: str, seed: int, seconds: float,
              device, with_control: bool, with_faults: bool) -> list:
    """[(reading, [Compared], failed, attempted, setup_s)] of one seed: the
    program's, each fault's and the control's."""
    import importlib

    import torch

    from vbbench import control
    from vbbench.record import Run

    t0 = time.perf_counter()
    run = Run(workload=name, cell=cell, config=config, traffic=traffic, seed=seed,
              seconds=seconds, trace=False, device=device)
    runner = importlib.import_module(f"vbbench.runners.{cell['runner']}").Runner(run)
    runner.setup()
    setup_s = time.perf_counter() - t0
    runner.window(time.perf_counter() + seconds)
    it = runner.outputs() if cell["runner"] == "train_realign" else None
    planted = iteration_faults(runner, it) if with_faults and it is not None else {}
    runner.free_program()
    lines = []
    if cell["runner"] == "lattice_decode":
        sample = runner.sample()
        lines.append(("program", runner.judge(sample, runner.program_outputs(sample))))
        if with_control:
            lines.append(("control", runner.judge(sample, control.decode_outputs(runner, sample))))
    else:
        lines.append(("program", runner.judge(it)))
        for fault, outputs in planted.items():
            lines.append((f"fault:{fault}", runner.judge(outputs)))
        if with_control:
            lines.append(("control", runner.judge(control.train_iteration(runner, it))))
    out = [(what, compared, run.failed, run.attempted, setup_s) for what, compared in lines]
    del runner, run
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


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

    harness.cache_env(harness.ROOT)
    if not torch.cuda.is_available():
        print("readings: no card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell, config, traffic = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        for what, compared, failed, attempted, setup_s in read_seed(
                cell, config, traffic, args.workload, seed, args.seconds,
                torch.device("cuda", 0), args.control, args.faults):
            rec = {"workload": args.workload, "seed": seed, "reading": what, "failed": failed,
                   "attempted": attempted, "setup_s": setup_s,
                   "numbers": {c.name: c.value for c in compared}}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

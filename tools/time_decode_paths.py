"""Time the full-width best-path decode and N-best decode of one checkout of
voicebridge_tpu_torch on one NVIDIA GPU, as ``chip_smoke.py`` phases 7 and
11 run them, so that two checkouts compare in one call.

    python tools/time_decode_paths.py [--tree DIR] [--label NAME]

``--tree`` is the root of the checkout to time (default: this one): its
``chip_smoke.py``, its ``voicebridge_tpu_torch`` and its ``tests/synth.py``
are imported, and its kernels built into its own ``_build``.  To compare
with the parent commit, unpack it under ``_archive/`` (``git archive``) and
run the two in turns in one call: parent, change, change, parent.  Prints
one JSON object: the card's name and power limit, and per path the median
audio seconds per second, the runs, the launch counts of one run and the
device busy share and device time by kernel of one profiled run; the log of
the phases (with the cProfile of one run of each) goes to
``chiprun_out/time_decode_paths_<label>.log``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "tests")]
    import torch

    if not torch.cuda.is_available():
        print("time_decode_paths: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as C
    from voicebridge_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out_dir = Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    device = torch.device("cuda", 0)
    _build.library()
    with open(out_dir / f"time_decode_paths_{args.label}.log", "w") as logf:
        def log(msg):
            print(msg, file=logf, flush=True)

        decode = C.decode_full_width(torch, device, C.FULL, log)
        nbest = C.nbest_full_width(torch, device, C.FULL, log)
    report = {"card": card, "tree": str(tree), "label": args.label}
    for key, facts in (("decode", decode), ("nbest", nbest)):
        report[key] = {"median_audio_s_per_s": facts["median_audio_s_per_s"],
                       "runs_s": facts["runs_s"], "audio_s": facts["audio_s"],
                       "launches": {k: n for k, n in facts["launches"].items() if n},
                       "device_busy_share": facts["profile"]["device_busy_share"],
                       "device_busy_s": facts["profile"]["device_busy_s"],
                       "top_device_ms": facts["profile"]["top_device_ms"]}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's WERs on the sequences that ``chip_smoke.py`` drives
through the port's ``Project``, run on the CPU; the smoke holds the port's
WERs to these.

    python tools/project_reference_wer.py librispeech [--speakers 24]
        [--utts 8] [--test-per 2] [--workdir DIR]
    python tools/project_reference_wer.py full_pipeline [--workdir DIR]

``librispeech``: ``examples/librispeech_shaped.py`` with these corpus
arguments and its own defaults for everything else (the whole ladder, mono
to tri3c); phase 18 runs ``examples/librispeech_shaped_torch.py`` with the
same arguments.  ``full_pipeline``: ``examples/full_pipeline_synthetic.py``
as it is.  Prints one JSON line: each stage's WER in percent.  The JAX
compilation cache goes into the work directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parent.parent


def librispeech(work: Path, speakers: int, utts: int, test_per: int) -> dict:
    sys.path.insert(0, str(ROOT / "examples"))
    from librispeech_shaped import main

    report = main([str(work), "--speakers", str(speakers), "--utts", str(utts),
                   "--test-per", str(test_per)])
    return {"corpus": report["corpus"], **{k: r["wer"] for k, r in report["wer"].items()}}


def full_pipeline(work: Path) -> dict:
    sys.path.insert(0, str(ROOT / "examples"))
    from full_pipeline_synthetic import main

    return {k: r.best_wer.wer for k, r in main(str(work)).items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sequence", choices=("librispeech", "full_pipeline"))
    ap.add_argument("--speakers", type=int, default=24)
    ap.add_argument("--utts", type=int, default=8)
    ap.add_argument("--test-per", type=int, default=2)
    ap.add_argument("--workdir", type=Path, default=None,
                    help="a fresh directory (default: one under the system's temp dir)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import tempfile

    work = args.workdir or Path(tempfile.mkdtemp(prefix=f"vb_{args.sequence}_"))
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(work / "jax_cache"))
    t0 = time.perf_counter()
    if args.sequence == "librispeech":
        out = librispeech(work, args.speakers, args.utts, args.test_per)
    else:
        out = full_pipeline(work)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()

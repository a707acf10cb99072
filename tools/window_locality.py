"""How close the sources of a graph's arcs lie in graph order, as seen by a
kernel that relaxes windows of consecutive destination states and could hold
the rows its slots read in shared memory (the layout PERF.md calls v3).

    python tools/window_locality.py [--states 60000] [--window 128] [--rows 192]

On the full-width synthetic graph (``testing.synth_decode_graph``), for the
decoder's forward plan (D = 8) and the lattice's backward plan: per window of
``--window`` destination graph states, the span [lo, hi) of graph states its
real slots read; the rows a frame would copy with at most ``--rows`` rows a
window (against the real-slot reads it replaces); and the share of real slots
whose source falls outside the rows copied.  Numpy on the host; prints one
JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from voicebridge_tpu_torch.ops import decode_core as DC  # noqa: E402
from voicebridge_tpu_torch.ops import lattice as LAT  # noqa: E402
from voicebridge_tpu_torch.testing import synth_decode_graph  # noqa: E402


def locality(plan, window: int, rows: int) -> dict:
    s1 = plan.num_states + 1
    real = plan.row_arc >= 0
    srcg = plan.sperm[plan.row_src][real]  # source graph state of each real slot
    dst_win = np.repeat(plan.sperm // window, np.diff(plan.row_start))
    win = np.broadcast_to(dst_win[:, None], real.shape)[real]
    n_win = -(-s1 // window)
    lo = np.full(n_win, s1, np.int64)
    hi = np.zeros(n_win, np.int64)
    np.minimum.at(lo, win, srcg)
    np.maximum.at(hi, win, srcg + 1)
    lo[hi == 0] = 0
    span = hi - lo
    kept = np.minimum(span, rows)
    outside = (srcg - lo[win]) >= kept[win]
    return {"windows": int(n_win), "span_median": float(np.median(span)),
            "span_max": int(span.max()), "rows_copied": int(kept.sum()),
            "real_slot_reads": int(real.sum()), "outside_share": float(outside.mean())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--states", type=int, default=60_000)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--rows", type=int, default=192)
    args = ap.parse_args()
    graph = synth_decode_graph(args.states, num_pdfs=2000)
    fwd = DC.build_emit_plan(graph, d=8)
    bwd = LAT.build_lattice_plans(graph, fwd_plan=fwd, device="cpu")[2]
    print(json.dumps({name: locality(plan, args.window, args.rows)
                      for name, plan in (("forward", fwd), ("backward", bwd))}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The least time an NVIDIA H100 could take for the JAX package's lane-major
lattice forward-backward (``voicebridge_tpu/ops/lattice.py``
``lattice_forward_backward`` with ``_window_fb``), worked out from its code at
the full-width lattice shape of ``chip_smoke.py`` phase 9: 128 utterances x
1000 frames, 2000 pdfs, the 60k-state / 480k-arc synthetic graph.

    python tools/lane_major_fb_bound.py

Bytes: each input read once (the [B, T, P] log-likelihoods, the arc arrays,
the final scores, the two reduction plans) and each output written once (the
packed survivor mask [T, B, ceil(A/8)], total_best, alpha_at_end,
use_final), over 3.35 TB/s.  Operations: per (lane, arc, frame) 4 in the
forward relaxation (a multiply, two adds, the tree's compare) and 6 in the
backward one (two adds for the tail, one for gamma, the survivor compare and
its mask, the tree's compare); per (lane, state, frame) 4 (the beam's max
and compare, the frame masks); over 67 TFLOP/s (float32 outside the tensor
cores).  The program is not ported (on no path of the JAX package); this is
the figure its row in PERF.md carries.  Prints one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from voicebridge_tpu.ops.viterbi import build_reduction_plan  # noqa: E402
from voicebridge_tpu_torch.testing import synth_decode_graph  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published


def main() -> int:
    b, t, p = 128, 1000, 2000
    g = synth_decode_graph(60_000, num_pdfs=p)
    s, a = g.num_states, g.num_arcs
    plans = sum(np.asarray(x).nbytes for src in (g.arc_dst, g.arc_src)
                for x in build_reduction_plan(src, s).levels)
    inputs = 4 * b * t * p + 4 * 4 * a + 4 * s + plans
    outputs = t * b * ((a + 7) // 8) + 4 * b * s + 4 * b + b
    ops = 10 * b * a * t + 4 * b * s * t
    byte_ms = 1e3 * (inputs + outputs) / HBM_BYTES_PER_S
    op_ms = 1e3 * ops / FP32_OPS_PER_S
    print(json.dumps({"lanes": b, "frames": t, "states": s, "arcs": a, "pdfs": p,
                      "bytes": inputs + outputs, "byte_ms": byte_ms, "operations": ops,
                      "operation_ms": op_ms, "bound_ms": max(byte_ms, op_ms),
                      "bound_by": "bytes" if byte_ms >= op_ms else "operations"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

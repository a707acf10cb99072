"""Profile the port's fMLLR statistics (``transforms/fmllr.acc_fmllr_stats``)
on the card at chip_smoke.py phase 16's training shape.

    python tools/profile_fmllr_stats.py [--rows 76800] [--speakers 8] [--calls 5]

Random 40-dim features, a 2000 x 5 GMM on their scale, random aligned pdfs,
weight 1 on every row.  After three warm-up calls, ``--calls`` calls run
under torch.profiler: prints the device time by operator (summed over the
calls), the device time per call and the host wall time per call.  Needs an
NVIDIA GPU; nothing here builds a kernel (the statistics are torch).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=76_800)
    ap.add_argument("--speakers", type=int, default=8)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from voicebridge_tpu_torch.ops import gmm_kernels
    from voicebridge_tpu_torch.testing import feature_scaled_am
    from voicebridge_tpu_torch.transforms import fmllr as F

    if not torch.cuda.is_available():
        print("profile_fmllr_stats: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, d = args.rows, 40
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    am = feature_scaled_am(np.zeros(d), np.ones(d), 2000, 5, seed=1)
    pdf = rng.integers(0, 2000, n)
    spk = np.repeat(np.arange(args.speakers), -(-n // args.speakers))[:n]
    stat_args = (gmm_kernels.pack_gmm(am, dev), am.means(), am.inv_vars, x, pdf,
                 np.ones(n, np.float32), spk, args.speakers)
    for _ in range(3):
        F.acc_fmllr_stats(*stat_args, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            F.acc_fmllr_stats(*stat_args, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20,
                                    max_name_column_width=60))
    device_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    print(f"{torch.cuda.get_device_name(0)}: {n} rows, {args.speakers} speakers: device time "
          f"{device_us / 1e3 / args.calls:.3f} ms a call, host wall {1e3 * wall / args.calls:.3f} "
          f"ms a call (under the profiler)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

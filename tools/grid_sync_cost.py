"""The cost of one ``cooperative_groups`` grid sync on the card: a
cooperative kernel of 256-thread blocks that only syncs, run with 0 and with
``--syncs`` syncs, timed by CUDA events, at one and two blocks an SM (the
grids of the port's cooperative kernels, ``csrc/lattice_lane.cu`` among
them).  Built with the package's nvcc flags into ``voicebridge_tpu_torch/
_build/``.

    python tools/grid_sync_cost.py [--syncs 1000]

Prints one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from voicebridge_tpu_torch import _build  # noqa: E402

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void __launch_bounds__(256, 2) syncs(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}
// ms of one cooperative launch of ``blocks`` blocks doing n syncs (after a
// warm-up launch), or -1 on an error
extern "C" float sync_ms(int blocks, int n) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  void* args[] = {&n};
  cudaLaunchCooperativeKernel((void*)syncs, blocks, 256, args, 0, 0);
  cudaEventRecord(a);
  cudaLaunchCooperativeKernel((void*)syncs, blocks, 256, args, 0, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = -1.f;
  if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--syncs", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grid_sync_cost: CUDA is not available", file=sys.stderr)
        return 1
    _build.BUILD_DIR.mkdir(exist_ok=True)
    src, lib_path = _build.BUILD_DIR / "grid_sync_cost.cu", _build.BUILD_DIR / "libgridsync.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.sync_ms.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.sync_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    res = {"card": card, "syncs": args.syncs}
    for per_sm in (1, 2):
        empty, full = lib.sync_ms(per_sm * sms, 0), lib.sync_ms(per_sm * sms, args.syncs)
        res[f"blocks_{per_sm * sms}"] = {"launch_ms": empty, "ms": full,
                                         "us_per_sync": 1e3 * (full - empty) / args.syncs}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the correctness
comparison, the metrics, and the result line.

Everything a cell is made of is found by name: the cell in
``benchmarks/workloads/<cell>.json`` (its configuration, traffic mix,
runner and correctness limits), the configuration in
``benchmarks/configs/<config>.json``, the traffic mix in
``benchmarks/traffic/<traffic>.json``, the runner in
``vbbench/runners/<runner>.py``, each metric's reader in
``benchmarks/metrics/<metric>.py`` and each layer's kernels in
``benchmarks/layers/<layer key>.json``.  Which metrics a cell reports comes
from ``BENCHMARK.json`` at the root of the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "voicebridge_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Refused(Exception):
    """The run cannot give a result (no card, a missing file, a forbidden
    module): exit non-zero and print no result line."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port may not load."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cache_env(root: Path) -> None:
    """Keep every kernel cache a run could fill inside the checkout, at
    fixed paths (the port builds its own kernels into its package's
    ``_build/``)."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}")
    return json.loads(path.read_text())


def named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise Refused(f"bad {kind} name {name!r}")
    return name


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell, each found by name."""
    cell = load_json(bench_dir / "workloads" / f"{named('cell', name)}.json")
    config = load_json(bench_dir / "configs" / f"{named('config', cell['config'])}.json")
    traffic = load_json(bench_dir / "traffic" / f"{named('traffic', cell['traffic'])}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, name: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that a cell reports: its
    end-to-end metrics without tracing, its per-layer metrics with it."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])]


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of a metric's reader file."""
    path = bench_dir / "metrics" / f"{named('metric', metric)}.py"
    if not path.is_file():
        raise Refused(f"no reader for metric {metric}: {path}")
    spec = importlib.util.spec_from_file_location(f"vbbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_facts(torch, run, chips: int) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(args, t_start: float, require_cuda: bool = True,
             bench_dir: Path = BENCH_DIR) -> dict:
    """Run one cell once and return the result object (``require_cuda``
    false and another ``bench_dir`` run a tiny copy of a cell on the CPU,
    for the tests)."""
    cell, config, traffic = load_cell(args.workload, bench_dir)
    bench = load_json(bench_dir.parent / "BENCHMARK.json")
    chips = int(next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload))
    metrics = cell_metrics(bench, args.workload, bool(args.trace))
    readers = {m["name"]: reader(m["name"], bench_dir) for m in metrics}
    import torch

    from . import trace as T
    from .record import Run

    if require_cuda:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: this benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} cards, {torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
    runner_mod = importlib.import_module(f"vbbench.runners.{named('runner', cell['runner'])}")
    run = Run(workload=args.workload, cell=cell, config=config, traffic=traffic,
              seed=int(args.seed), seconds=float(args.seconds), trace=bool(args.trace),
              device=device)
    runner = runner_mod.Runner(run)
    run.phases["start and imports"] = time.perf_counter() - t_start
    runner.setup()
    if device.type == "cuda":  # the memory peak is read over the window alone
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_start
    run.spans, run.counters, run.work, run.requests = {}, {}, {}, []
    layers = T.load_layers(bench_dir / "layers")
    with T.profiled(run.trace) as prof, (torch.profiler.record_function(T.WINDOW) if prof
                                          else contextlib.nullcontext()):
        t0 = time.perf_counter()
        runner.window(t0 + run.seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run.window_s = time.perf_counter() - t0
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {', '.join(found[:10])}")
    facts = device_facts(torch, run, chips)
    if prof is not None:
        run.device_trace = T.summarize(prof, layers)
        del prof
        facts["busy_s"] = run.device_trace["busy_s"]
        facts["window_s"] = run.device_trace["window_s"]
    runner.check()
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if v is not None and math.isfinite(v):
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(run.compared) and all(c.ok for c in run.compared)
              and run.failed == 0,
              "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": values, "device": facts}
    if run.device_trace is not None:
        result["breakdown"] = {"device_ops": run.device_trace["device_ops"],
                               "idle_gaps": run.device_trace["idle_gaps"]}
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.compared}
    for phase, s in run.phases.items():
        print(f"set-up: {phase} {s:.3f} s", file=sys.stderr)
    return result


def parse(argv: list) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list, t_start: float) -> int:
    args = parse(argv)
    cache_env(ROOT)
    try:
        result = run_cell(args, t_start)
    except Refused as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

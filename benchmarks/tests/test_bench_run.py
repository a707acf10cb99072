"""Whole runs of the tiny cells on the CPU: the result line, the traced
run, the faults and the control that the comparison must catch, the
refusal without a card, and no JAX anywhere."""

import argparse
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT, copy_bench

import readings
from vbbench import faults, harness

CELLS = ("tri1.lattice", "tri2b.train_realign")
SEED = 2 ** 31 + 11


def run_tiny(bench_dir, cell, trace=0, seed=SEED, seconds=1.0):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    return harness.run_cell(args, time.perf_counter(), require_cuda=False, bench_dir=bench_dir)


def check_schema(res: dict, trace: bool):
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared" and (("breakdown" in keys) == trace)
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["attempted"] > 0
    assert isinstance(res["failed"], int)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(x) <= 10 for x in res["breakdown"].values())
    for c in res["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_prints_its_result_line(tiny_bench, cell):
    res = run_tiny(tiny_bench, cell)
    check_schema(res, trace=False)
    assert res["correct"] and res["failed"] == 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert set(res["metrics"]) == want
    # the plain references agree with the program's plain versions closely
    c = {k: v["value"] for k, v in res["compared"].items()}
    if cell == "tri1.lattice":
        assert c["feat_err"] < 2e-3 and c["lat_miss"] < 1e-2
    else:
        assert c["ali_gap"] < 1e-6 and c["stats_err"] < 1e-5 and c["model_err"] < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(tiny_bench, cell):
    res = run_tiny(tiny_bench, cell, trace=1)
    check_schema(res, trace=True)
    names = set(res["metrics"])
    if cell == "tri1.lattice":
        assert {"features_ms.decode", "survivors_per_frame.decode", "mfu.decode"} <= names
    else:
        assert {"realign_ms.train", "estep_ms.train", "mstep_ms.train", "mfu.train"} <= names
    # no device on the CPU: no roofline share is made up
    assert not any(n.endswith("_roofline.decode") or n.endswith("_roofline.train")
                   for n in names)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[harness.load_cell(c)[0]["runner"]]])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(tiny_bench, cell, fault):
    runner = json.loads((tiny_bench / "workloads" / f"{cell}.json").read_text())["runner"]
    with faults.planted(runner, fault):
        res = run_tiny(tiny_bench, cell)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(tiny_bench, cell):
    spec, config, traffic = harness.load_cell(cell, tiny_bench)
    lines = dict((what, compared) for what, compared, *_ in readings.read_seed(
        spec, config, traffic, cell, SEED, 1.0, torch.device("cpu"), True, False))
    assert all(c.ok for c in lines["program"])
    assert not all(c.ok for c in lines["control"]), [(c.name, c.value) for c in lines["control"]]


def test_without_a_card_the_run_prints_no_result(tmp_path):
    copy_bench(tmp_path)
    shutil.copytree(BENCH / "vbbench", tmp_path / "benchmarks" / "vbbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "run.py", tmp_path / "benchmarks" / "run.py")
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", CELLS[0],
                               "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stdout


def test_nothing_the_benchmark_runs_loads_jax():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}]
import importlib, pathlib
import vbbench.reference.align, vbbench.reference.frontend, vbbench.reference.gmm
import vbbench.reference.lattice, vbbench.judge, vbbench.control
plain = [m for m in sys.modules if m.split('.')[0] == 'voicebridge_tpu_torch']
import vbbench.harness, vbbench.traffic, vbbench.models, vbbench.faults, readings
import vbbench.runners.lattice_decode, vbbench.runners.train_realign
from vbbench import harness
for p in sorted(pathlib.Path({str(BENCH)!r}, 'metrics').glob('*.py')):
    harness.reader(p.stem)
for p in sorted(pathlib.Path({str(BENCH)!r}, 'traffic').glob('*.py')):
    vbbench.traffic.kind(p.stem)
import voicebridge_tpu_torch.steps.decode, voicebridge_tpu_torch.steps.train_tri
import voicebridge_tpu_torch.steps.make_feats, voicebridge_tpu_torch.steps.align
print(plain, harness.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


def test_forbidden_names_are_compared_whole():
    name = "voicebridge_tpu_torch_lookalike"
    sys.modules.setdefault("jaxlib_lookalike", sys)
    try:
        assert not any(m.startswith("jaxlib_lookalike") for m in harness.forbidden_modules())
        assert name.split(".")[0] not in harness.FORBIDDEN
        assert "voicebridge_tpu_torch" not in harness.FORBIDDEN
    finally:
        sys.modules.pop("jaxlib_lookalike", None)

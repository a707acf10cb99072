"""Whole runs of tiny copies of ``tri5b.fmllr_decode`` and
``tri2b.train_ali`` on the CPU: judged correct, their per-layer metrics in
a traced run, and a fault planted under the timed path caught."""

import argparse
import json
import time

import numpy as np
import pytest
from conftest import BENCH, ROOT, TINY, copy_bench

from vbbench import harness

SEED = 2 ** 31 + 23
SAT_TINY = {
    "configs/tri5b-libri.json": {"model": {"num_pdfs": 60, "num_gauss": 300},
                                 "topology": {"num_phones": 10, "silence_phones": 2},
                                 "graph": {"num_states": 400, "max_jump": 16,
                                           "vocabulary": 50}},
    "workloads/tri5b.fmllr_decode.json": {"check": {"requests": 1, "speakers_per_request": 1}},
    "traffic/train10k_2to20s_fixed_ali.json": TINY["traffic/train10k_2to20s.json"],
    "workloads/tri2b.train_ali.json": {"check": {"utts": 6}},
}


@pytest.fixture(scope="module")
def sat_bench(tmp_path_factory):
    sizes = {**TINY, **SAT_TINY}
    sizes["traffic/batch128_10s.json"] = {**TINY["traffic/batch128_10s.json"], "batch_utts": 8,
                                          "frames": 60}
    return copy_bench(tmp_path_factory.mktemp("sat"), sizes)


def run_tiny(bench_dir, cell, trace=0):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=1.0, trace=trace)
    return harness.run_cell(args, time.perf_counter(), require_cuda=False, bench_dir=bench_dir)


def test_the_new_cells_are_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["tri5b.fmllr_decode"]["config"] == "tri5b-libri"
    assert cells["tri2b.train_ali"]["config"] == "tri2b-libri"
    config = json.loads((BENCH / "configs" / "tri5b-libri.json").read_text())
    m = config["model"]
    assert (m["num_pdfs"], m["num_gauss"], m["dim"]) == (5000, 100000, 40)
    assert config["fmllr"] == {"update_type": "full", "min_count": 500.0, "silence_weight": 0.01}
    assert config["reduced"] == ["graph"] and config["graph"]["num_states"] == 250000


def test_every_configuration_and_traffic_pair_is_one_cell():
    """A cell is one configuration under one traffic mix: ``tri2b.train_ali``
    has its own mix, the training set of ``train10k_2to20s`` under EM over
    fixed alignments, and ``tri5b-libri`` its own source."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    sources = [(c["source"], c["reduced"]) for c in bench["configs"]]
    assert all(sources.count(s) == 1 for s in sources)
    corpus = json.loads((BENCH / "traffic" / "train10k_2to20s.json").read_text())
    assert json.loads((BENCH / "traffic" / "train10k_2to20s_fixed_ali.json").read_text()) == corpus


@pytest.mark.parametrize("cell", ["tri5b.fmllr_decode", "tri2b.train_ali"])
def test_a_tiny_run_is_correct(sat_bench, cell):
    res = run_tiny(sat_bench, cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(res["metrics"]) == {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    c = {k: v["value"] for k, v in res["compared"].items()}
    if cell == "tri5b.fmllr_decode":
        # the program's plain versions on the CPU against float64
        assert c["feat_err"] < 1e-3 and c["cost_err"] < 1e-2 and c["lat_miss"] < 1e-2
    else:
        assert c["ali_gap"] < 1e-6 and c["stats_err"] < 1e-5 and c["model_err"] < 1e-5


@pytest.mark.parametrize("cell,names", [
    ("tri5b.fmllr_decode", {"fmllr_post_ms.sat", "fmllr_estimate_ms.sat", "determinize_ms.sat",
                            "mfu.decode", "idle_share.decode"}),
    ("tri2b.train_ali", {"estep_ms.train", "mstep_ms.train", "host_syncs.train", "mfu.train"})])
def test_a_traced_run_reports_the_per_layer_metrics(sat_bench, cell, names):
    res = run_tiny(sat_bench, cell, trace=1)
    assert res["correct"]
    assert names <= set(res["metrics"])
    assert not any("roofline" in n for n in res["metrics"])  # no card: nothing made up


def _perturb_row(monkeypatch):
    """One transform row of every estimate moved off its value."""
    from voicebridge_tpu_torch.steps import decode_fmllr as DF

    solve = DF.estimate_fmllr_rows

    def estimate(*args, **kwargs):
        trans, imprs = solve(*args, **kwargs)
        trans = trans.copy()
        trans[:, 0, 0] += 0.01
        return trans, imprs

    monkeypatch.setattr(DF, "estimate_fmllr_rows", estimate)


def _drop_accumulator(monkeypatch):
    """The E-step's statistics of one pdf dropped."""
    from voicebridge_tpu_torch.steps import train_tri

    e_step = train_tri.e_step

    def dropped(*args, **kwargs):
        occ, macc, vacc, tstats, ll = e_step(*args, **kwargs)
        p = int(np.argmax(np.asarray(occ).sum(axis=1)))
        occ, macc, vacc = (np.array(a, copy=True) for a in (occ, macc, vacc))
        occ[p], macc[p], vacc[p] = 0.0, 0.0, 0.0
        return occ, macc, vacc, tstats, ll

    monkeypatch.setattr(train_tri, "e_step", dropped)


@pytest.mark.parametrize("cell,plant,caught", [
    ("tri5b.fmllr_decode", _perturb_row, "feat_err"),
    ("tri2b.train_ali", _drop_accumulator, "stats_err")])
def test_a_planted_fault_makes_the_run_incorrect(sat_bench, monkeypatch, cell, plant, caught):
    plant(monkeypatch)
    res = run_tiny(sat_bench, cell)
    assert not res["correct"]
    c = res["compared"][caught]
    assert c["value"] > c["limit"]


"""On the card, at the cells' own sizes: the program's readings pass the
limits and the control's (the references in TF32 in its place) fail them;
a short run prints a correct result line naming the card.  Skips without
the card."""

import argparse
import time

import pytest
from test_bench_run import check_schema

import readings
from vbbench import harness

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell,seconds", [("tri1.lattice", 3.0), ("tri2b.train_realign", 0.0)])
def test_the_control_fails_where_the_program_passes(card, cell, seconds):
    spec, config, traffic = harness.load_cell(cell)
    lines = {what: compared for what, compared, *_ in readings.read_seed(
        spec, config, traffic, cell, 2 ** 31 + 101, seconds, card, True, False)}
    assert all(c.ok for c in lines["program"]), [(c.name, c.value) for c in lines["program"]]
    assert not all(c.ok for c in lines["control"])


@pytest.mark.parametrize("cell", ["tri1.lattice", "tri2b.train_realign"])
def test_a_short_run_on_the_card(card, cell):
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 202, seconds=5.0, trace=1)
    res = harness.run_cell(args, time.perf_counter())
    check_schema(res, trace=True)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0

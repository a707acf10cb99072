"""The per-layer metrics read from the program's own spans and counters
(``vbbench/program_spans.py``): a traced tiny run of each cell reports
them, and a program that records nothing gives none."""

import argparse
import time

import pytest
import torch

from vbbench import harness, program_spans
from vbbench.record import Run

SEED = 2 ** 31 + 23
NEW = {"tri1.lattice": {"survivor_assembly_ms.decode", "host_syncs.decode"},
       "tri2b.train_realign": {"align_wait_ms.train", "align_assembly_ms.train",
                               "align_apply_ms.train", "host_syncs.train"}}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reports_the_program_span_metrics(tiny_bench, cell):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=1.0, trace=1)
    res = harness.run_cell(args, time.perf_counter(), require_cuda=False, bench_dir=tiny_bench)
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in NEW[cell]}
    assert set(got) == NEW[cell]
    assert all(v > 0 for v in got.values()), got
    # no span of the program reaches the device trace's operations
    assert not any(name.startswith("vbt.") for name, _t in res["breakdown"]["device_ops"])
    if cell == "tri1.lattice":
        # 1 + 5 a sub-batch + 1 a window under decode_lattice, and 1 a K1 bucket
        assert got["host_syncs.decode"] >= 7
    else:
        # four reads a sub-batch, five in the E-step
        assert got["host_syncs.train"] >= 9


def _run(requests) -> Run:
    return Run(workload="w", cell={}, config={}, traffic={}, seed=1, seconds=1.0, trace=True,
               device=torch.device("cpu"), requests=requests)


def test_nothing_to_read_gives_none(monkeypatch):
    from voicebridge_tpu_torch.utils import profiling

    run = _run([("decode", 10.0, 1.0), ("train", 10.0, None)])
    with monkeypatch.context() as m:  # an empty session
        m.setattr(profiling, "session", lambda: profiling.Session([], {}, None))
        assert program_spans.span_ms(run, "decode", "lattice.survivors") is None
        assert program_spans.counter(run, "train", "host_sync") is None
    with profiling.recording():
        with profiling.span("lattice.survivors"):
            profiling.count("host_sync", 3)
    assert program_spans.span_ms(run, "decode", "lattice.survivors") > 0
    assert program_spans.counter(run, "train", "host_sync") == 3
    assert program_spans.counter(_run([]), "train", "host_sync") is None
    # a program without the recorder (an earlier commit of it)
    monkeypatch.delattr(profiling, "session")
    assert program_spans.span_ms(run, "decode", "lattice.survivors") is None
    assert program_spans.counter(run, "train", "host_sync") is None

"""The work counts behind the roofline shares and ``mfu``, on shapes small
enough to count by hand, and the readers on runs with nothing to read."""

import math

import pytest
import torch

from vbbench import counts, readers
from vbbench.record import Run


def test_gmm_counts_products_at_the_tf32_peak():
    ops, nbytes = counts.gmm(frames=3, gaussians=5, dim=2, pdfs=4)
    # 2 (2D + 1) = 10 operations a (frame, Gaussian): 3 * 5 * 10
    assert ops == {"tf32": 150.0}
    # features in (3 x 2) and log-likelihoods out (3 x 4), 4 bytes each
    assert nbytes == 4 * (6 + 12)


def test_lattice_counts_each_arc_once_a_frame_and_lane():
    ops, nbytes = counts.lattice(frames=2, lanes=3, arcs=5, pdfs=7, survivors=11,
                                 graph_bytes=80)
    assert ops == {"fp32": 8.0 * 2 * 3 * 5 + 2 * 3 * 7}
    assert nbytes == 4 * 2 * 3 * 7 + 80 + 8 * 11


def test_mfcc_counts():
    ops, nbytes = counts.mfcc(frames=2, window=4, n_fft=8, bins=3, ceps=2, samples=10)
    per_frame = 6 * 4 + 2.5 * 8 * 3 + 3 * 4 + 4 * 4 + 3 + 2 * 3 * 2 + 2
    assert ops == {"fp32": 2 * per_frame}
    assert nbytes == 4 * (10 + 2 * 2)


def test_alignment_and_statistics_counts():
    assert counts.banded_alignment(frame_states=10, arcs_per_state=2.5) == {"fp32": 50.0}
    got = counts.aligned_stats(frames=4, gaussians_per_frame=2, dim=3)
    assert got == {"fp32": 4 * 2 * (2 * 7 + 4 + 1 + 15)}


def test_least_time_is_the_larger_of_operations_and_bytes():
    work = {"ops": {"fp32": 67e12, "tf32": 495e12}, "bytes": 3.35e12}
    assert counts.ops_s(work) == pytest.approx(2.0)
    assert counts.least_s(work) == pytest.approx(2.0)
    work["bytes"] = 3 * 3.35e12
    assert counts.least_s(work) == pytest.approx(3.0)


def _run(**kw) -> Run:
    return Run(workload="w", cell={}, config={}, traffic={}, seed=1, seconds=1.0, trace=True,
               device=torch.device("cpu"), **kw)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    run = _run()
    assert readers.roofline(run, "lattice") is None
    assert readers.idle(run, "decode") is None
    assert readers.mfu(run, "decode") is None
    assert readers.mean_ms(run, "features") is None


def test_readers_on_a_traced_run():
    run = _run(window_s=2.0)
    run.requests = [("decode", 12.8, 0.5)]
    run.add_work("lattice", {"fp32": 67e9}, 0.0)  # 1 ms at the fp32 peak
    run.device_trace = {"busy_s": 1.5, "window_s": 2.0, "layer_s": {"lattice": 0.004},
                        "kernel_s": {}, "device_ops": [], "idle_gaps": []}
    assert readers.roofline(run, "lattice") == pytest.approx(25.0)
    assert readers.idle(run, "decode") == pytest.approx(25.0)
    assert readers.mfu(run, "decode") == pytest.approx(0.05)
    assert readers.idle(run, "train") is None
    assert math.isfinite(readers.mfu(run, "decode"))


def test_trace_summary_on_a_toy_profile():
    """Busy time is the union of device intervals without the span
    annotations mirrored onto the device; idle time goes to the spans it
    lies in."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from vbbench import trace

    def ev(name, kind, a, b):
        return NS(name=name, device_type=kind, time_range=NS(start=a, end=b))

    events = [ev(trace.WINDOW, DeviceType.CPU, 0, 50), ev("bench:a", DeviceType.CPU, 0, 25),
              ev("bench:b", DeviceType.CPU, 25, 50), ev("k1", DeviceType.CUDA, 10, 20),
              ev("k2", DeviceType.CUDA, 15, 22), ev("k3", DeviceType.CUDA, 30, 40),
              ev("bench:a", DeviceType.CUDA, 0, 25)]
    out = trace.summarize(NS(events=lambda: events), {"x": {"layer": "X", "kernels": ["k1", "k3"]}})
    assert out["busy_s"] == pytest.approx(22e-6)
    assert out["window_s"] == pytest.approx(50e-6)
    assert out["layer_s"]["x"] == pytest.approx(20e-6)
    assert dict(out["idle_gaps"]) == pytest.approx({"a": 13e-6, "b": 15e-6})
    assert [n for n, _ in out["device_ops"]] == ["k1", "k3", "k2"]

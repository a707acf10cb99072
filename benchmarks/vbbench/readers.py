"""Shared arithmetic of the metric readers in ``benchmarks/metrics/``.  Each
returns None where the run has nothing to read: that metric is then left
out of the result line, never reported as 0."""

from __future__ import annotations

from . import counts


def mean_ms(run, span: str):
    """Mean duration of a benchmark span in the window, in milliseconds."""
    spans = run.spans.get(span)
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)


def roofline(run, layer: str):
    """A layer's least time (``counts``) over the device time of its
    kernels in the traced window, in percent."""
    trace, work = run.device_trace, run.work.get(layer)
    if trace is None or work is None or trace["layer_s"].get(layer, 0.0) <= 0.0:
        return None
    return 100.0 * counts.least_s(work) / trace["layer_s"][layer]


def served(run, kind: str) -> bool:
    return any(r[0] == kind for r in run.requests)


def idle(run, kind: str):
    """The share of the traced window with no operation on the card, in
    percent."""
    trace = run.device_trace
    if trace is None or trace["window_s"] <= 0 or not served(run, kind):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def mfu(run, kind: str):
    """Every layer's operations at the peak of their precision, summed, over
    the window's wall time, in percent."""
    if run.window_s <= 0 or not run.work or not served(run, kind):
        return None
    return 100.0 * sum(counts.ops_s(w) for w in run.work.values()) / run.window_s

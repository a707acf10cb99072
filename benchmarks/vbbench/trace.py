"""The device trace of a run's window (``--trace 1``): torch.profiler over
the window, then the device time by kernel and by layer, the device's busy
time (the union of its operations' intervals), and the idle time split
by the benchmark span the host was in.

A layer's kernels are listed in ``benchmarks/layers/<layer key>.json``
(``{"layer": ..., "kernels": [substrings of kernel names]}``); a kernel
belongs to every layer one of whose substrings its name holds.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

WINDOW = "bench:window"


def load_layers(layer_dir: Path) -> dict:
    """layer key -> {"layer": name, "kernels": [...]} for every mapping file."""
    out = {}
    for path in sorted(layer_dir.glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = {"layer": spec["layer"], "kernels": list(spec["kernels"])}
    return out


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields the profiler (None when off); the caller marks the window
    with ``record_function(WINDOW)`` inside."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, layers: dict, top: int = 10) -> dict:
    """Read the profile of a window: busy_s, window_s, kernel_s, layer_s,
    device_ops and idle_gaps (seconds)."""
    from torch.autograd import DeviceType

    events = prof.events()
    window = next(e.time_range for e in events
                  if e.name == WINDOW and e.device_type == DeviceType.CPU)
    w0, w1 = window.start, window.end
    spans, dev = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors each record_function range onto the device's
            # timeline as an annotation: not an operation of the card
            if w0 <= tr.start <= w1 and not e.name.startswith("bench:"):
                dev.append((e.name, tr.start, min(tr.end, w1)))
        elif e.name.startswith("bench:") and e.name != WINDOW and w0 <= tr.start <= w1:
            spans.append((tr.start, tr.end, e.name[len("bench:"):]))
    kernel_s: dict = {}
    for name, s, e in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e6
    layer_s = {key: sum(t for name, t in kernel_s.items()
                        if any(k in name for k in spec["kernels"]))
               for key, spec in layers.items()}
    busy = _merge([[s, e] for _name, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    spans.sort()
    j = 0
    for g0, g1 in idle:  # both sorted and each non-overlapping: one sweep
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(spans) and spans[k][0] < g1:
            part = min(g1, spans[k][1]) - max(g0, spans[k][0])
            if part > 0:
                gaps[spans[k][2]] = gaps.get(spans[k][2], 0.0) + part / 1e6
                covered += part
            k += 1
        if g1 - g0 > covered:
            gaps["between spans"] = gaps.get("between spans", 0.0) + (g1 - g0 - covered) / 1e6
    by_time = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6, "kernel_s": kernel_s,
            "layer_s": layer_s,
            "device_ops": [[name[:120], t] for name, t in by_time[:top]],
            "idle_gaps": [[name, t] for name, t in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}

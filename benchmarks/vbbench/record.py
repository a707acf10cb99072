"""What one run records: its requests, spans, counters, work counts, the
device trace, and the numbers its correctness comparison read.  Metric
readers (``benchmarks/metrics/<name>.py``) take a ``Run`` and nothing else.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Compared:
    """One number of the correctness comparison beside its limit: the run
    is correct only where ``value <= limit`` for every one."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclass
class Run:
    workload: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    # set-up phase -> seconds, printed on standard error
    phases: dict = field(default_factory=dict)
    window_s: float = 0.0
    # (kind, audio seconds, latency seconds) of every request completed in the window
    requests: list = field(default_factory=list)
    # benchmark span name -> durations (seconds) inside the window
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    # layer key -> {"ops": {peak name: operations}, "bytes": bytes}, inside the window
    work: dict = field(default_factory=dict)
    # from the traced run: busy_s, window_s, kernel_s {name: s}, layer_s {layer key: s}
    device_trace: dict | None = None
    attempted: int = 0
    failed: int = 0
    compared: list = field(default_factory=list)

    def add_work(self, layer: str, ops: dict | None = None, nbytes: float = 0.0) -> None:
        w = self.work.setdefault(layer, {"ops": {}, "bytes": 0.0})
        for peak, n in (ops or {}).items():
            w["ops"][peak] = w["ops"].get(peak, 0.0) + float(n)
        w["bytes"] += float(nbytes)

    def count(self, name: str, n: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark span around a call into the program: the device is
        synchronised at both ends, so the span holds the call's device work;
        with tracing on, the profiler sees it as ``bench:<name>``."""
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        marker = (torch.profiler.record_function(f"bench:{name}") if self.trace
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        with marker:
            yield
            if sync:
                torch.cuda.synchronize(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

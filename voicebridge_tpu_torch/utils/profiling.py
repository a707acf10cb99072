"""Spans, counters and traces of the port's own work.

The reference has only ``kaldi::Timer`` + per-job logs (``base/timer.h``);
the port records where its time goes itself:

* ``span(name)`` — a context manager around a piece of the port's work on
  the host: its name, start and end on ``time.perf_counter_ns()``, the span
  that encloses it and the root span of its call (the spans of one request
  or iteration share that root).  ``count(name, n)`` adds to a counter.
  ``to_host(tensor, name)`` is a ``.cpu()`` read recorded as a span
  ``sync.<name>`` and counted as ``host_sync`` / ``host_sync_bytes``.
* They record while a ``torch.profiler`` profile records (the rule
  ``record_function`` follows) or inside ``recording()``; otherwise ``span``
  returns a no-op context and ``count`` returns at once, after one check.
  No span synchronises the device: a span around launches holds their
  enqueue, and the wait shows in the ``sync.*`` span that follows.
* ``session()`` — the spans and counters of the newest recording session,
  each span with its self time (its duration less its child spans').  A
  session starts at the first span or count after recording turned on and
  replaces the one before.  Under a profiler the port did not start, a
  session ends when ``session()`` is read with recording off.
* ``trace(logdir)`` — a ``torch.profiler`` trace of the enclosed block as a
  Chrome trace (Perfetto, TensorBoard) in ``logdir``; inside it every span is
  also a ``record_function`` range ``vbt.<name>``, on the profiler's clock
  beside the torch ops and the device's kernels.
* ``StageTimer`` — wall time per pipeline stage with audio-seconds
  accounting (the examples' ``report.json``); each stage is a span.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch

from .logging import get_logger

log = get_logger()

_profiler_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    """One recorded span; times in ``time.perf_counter_ns()``."""

    id: int
    name: str
    parent: int | None  # id of the enclosing span
    root: int  # id of the outermost span of the call (its own id for a root)
    start_ns: int
    end_ns: int  # 0 while open
    self_ns: int  # duration less the child spans' durations


class Session(NamedTuple):
    """The spans and counters of one recording session.  ``anchor`` is a
    ``(perf_counter_ns, time_ns)`` pair read together at its start, which
    places the spans on Unix time (the profiler's clock)."""

    spans: list
    counters: dict
    anchor: tuple | None


class _State:
    explicit = 0  # depth of recording() blocks
    ranges = False  # inside trace(): spans are record_function ranges too
    stale = True  # the next record starts a new session
    spans: list = []  # [name, parent, root, start_ns, end_ns] by span id
    counters: dict = {}
    anchor: tuple | None = None


_local = threading.local()
_lock = threading.Lock()


def _records() -> list:
    """The current session's span list, starting a new session if due."""
    if _State.stale:
        with _lock:
            if _State.stale:
                _State.spans, _State.counters = [], {}
                _State.anchor = (time.perf_counter_ns(), time.time_ns())
                _State.stale = False
    return _State.spans


class _Span:
    __slots__ = ("name", "records", "sid", "rng")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        records = self.records = _records()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack and stack[-1][0] is records else None
        entry = [self.name, parent[1] if parent else None, None, 0, 0]
        with _lock:
            self.sid = len(records)
            records.append(entry)
        entry[2] = parent[2] if parent else self.sid
        stack.append((records, self.sid, entry[2]))
        self.rng = None
        if _State.ranges:
            self.rng = torch.profiler.record_function("vbt." + self.name)
            self.rng.__enter__()
        entry[3] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        if self.rng is not None:
            self.rng.__exit__(*exc)
        self.records[self.sid][4] = t
        _local.stack.pop()
        return False


def span(name: str):
    """A span around the enclosed block while recording; a no-op context
    otherwise."""
    if not (_State.explicit or _profiler_enabled()):
        return _NOOP
    return _Span(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording."""
    if not (_State.explicit or _profiler_enabled()):
        return
    _records()
    with _lock:
        _State.counters[name] = _State.counters.get(name, 0) + n


class _Sync(_Span):
    __slots__ = ("nbytes",)

    def __init__(self, name: str, nbytes: int):
        super().__init__("sync." + name)
        self.nbytes = nbytes

    def __exit__(self, *exc):
        super().__exit__(*exc)
        count("host_sync")
        count("host_sync_bytes", self.nbytes)
        return False


def host_wait(name: str, nbytes: int = 0):
    """Around a call in which the host waits on the device (a read-back),
    while recording: the span ``sync.<name>``, one ``host_sync`` and
    ``nbytes`` of ``host_sync_bytes``.  A no-op context otherwise."""
    if not (_State.explicit or _profiler_enabled()):
        return _NOOP
    return _Sync(name, nbytes)


def to_host(tensor: torch.Tensor, name: str) -> torch.Tensor:
    """``tensor.cpu()``; while recording, inside a ``host_wait`` of its
    bytes."""
    if not (_State.explicit or _profiler_enabled()):
        return tensor.cpu()
    with _Sync(name, tensor.numel() * tensor.element_size()):
        return tensor.cpu()


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, profiler or not; a new
    session starts at its first record."""
    with _lock:
        _State.explicit += 1
        _State.stale = True
    try:
        yield
    finally:
        with _lock:
            _State.explicit -= 1
            _State.stale = True


def session() -> Session:
    """The newest recording session, each span with its self time."""
    with _lock:
        spans = [list(s) for s in _State.spans]
        counters = dict(_State.counters)
        anchor = _State.anchor
        if not (_State.explicit or _profiler_enabled()):
            _State.stale = True
    covered = [0] * len(spans)
    for name, parent, root, t0, t1 in spans:
        if parent is not None and t1:
            covered[parent] += t1 - t0
    out = [Span(i, name, parent, root, t0, t1, (t1 - t0 - covered[i]) if t1 else 0)
           for i, (name, parent, root, t0, t1) in enumerate(spans)]
    return Session(out, counters, anchor)


@contextlib.contextmanager
def trace(logdir: str | Path | None):
    """torch.profiler trace of the enclosed block, CPU and (when present)
    CUDA activity, written as a Chrome trace into ``logdir`` (no-op when
    logdir=None).  Spans inside are ``vbt.<name>`` ranges in the trace and
    form a new session."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        _State.stale, _State.ranges = True, True
        try:
            yield
        finally:
            _State.ranges = False
    _State.stale = True
    prof.export_chrome_trace(str(Path(logdir) / f"trace_{time.time_ns()}.json"))


def _sync_card() -> None:
    """Wait for the current card's work, where the process has used CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StageTimer:
    """Accumulates per-stage wall time and processed audio seconds.  A stage
    is a span of its name; on CUDA it ends with a device synchronisation, so
    its wall time holds its device work.

    Usage::

        timer = StageTimer()
        with timer.stage("mfcc", audio_s=total_audio):
            ...
        timer.report()   # logs audio-s/s per stage + totals
    """

    stages: dict = field(default_factory=dict)  # name -> [wall_s, audio_s, n]

    @contextlib.contextmanager
    def stage(self, name: str, audio_s: float = 0.0):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                _sync_card()
        finally:
            wall = time.perf_counter() - t0
            w, a, n = self.stages.get(name, (0.0, 0.0, 0))
            self.stages[name] = (w + wall, a + audio_s, n + 1)

    def report(self) -> dict:
        out = {}
        for name, (w, a, n) in self.stages.items():
            entry = {"wall_s": round(w, 3), "calls": n}
            if a:
                entry["audio_s"] = round(a, 2)
                entry["audio_s_per_s"] = round(a / w, 2) if w else 0.0
            out[name] = entry
            log.info("stage %-16s wall=%7.2fs calls=%d%s", name, w, n,
                     f" audio-s/s={entry.get('audio_s_per_s')}" if a else "")
        return out

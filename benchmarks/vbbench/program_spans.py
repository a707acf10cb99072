"""Readings of the program's own spans and counters
(``voicebridge_tpu_torch.utils.profiling``) in a traced run's window, per
request or iteration.

The program records them while the window's profiler records and keeps
them in memory; ``session()`` after the window gives the newest recording
session, each span with its self time.  Every function returns None where
there is nothing to read: a program without that recorder, an empty
session, or no request of the kind in the run.
"""

from __future__ import annotations


def _session():
    """The program's newest recording session, or None."""
    try:
        from voicebridge_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "session", None)
    sess = read() if read is not None else None
    if sess is None or not (getattr(sess, "spans", None) or getattr(sess, "counters", None)):
        return None
    return sess


def _served(run, kind: str) -> int:
    return sum(1 for r in run.requests if r[0] == kind)


def span_ms(run, kind: str, name: str, whole: bool = False):
    """The self time (``whole``: the duration) of every span ``name``,
    summed, in milliseconds per request of ``kind``."""
    n, sess = _served(run, kind), _session()
    if not n or sess is None:
        return None
    spans = [s for s in sess.spans if s.name == name and s.end_ns]
    if not spans:
        return None
    return 1e-6 * sum((s.end_ns - s.start_ns) if whole else s.self_ns for s in spans) / n


def counter(run, kind: str, name: str):
    """A program counter's total per request of ``kind``."""
    n, sess = _served(run, kind), _session()
    if not n or sess is None or name not in sess.counters:
        return None
    return sess.counters[name] / n

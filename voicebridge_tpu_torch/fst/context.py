"""Context expansion: CLG = C . LG via dynamic (lazy) composition.

Counterpart of Kaldi's lazy ``ContextFst`` + ``fstcomposecontext``
(``fstext/context-fst.h:76-330``): never materializes C, walks LG and grows
context histories on the fly.  Supports monophone (N=1) and the reference's
triphone setting N=3/P=1; utterance-final context is closed with a
subsequential symbol '$' repeated N-P-1 times (``AddSubsequentialLoop``).

``ilabel_info`` output convention matches hmm_graph.py: entry 0 = epsilon (),
disambig symbols = (-sym,), windows = N-tuples (0-padded at boundaries).
"""

from __future__ import annotations

from .core import EPS, Fst, NO_STATE_ID, ZERO


def add_subsequential_loop(fst: Fst, subseq_sym: int, times: int = 1) -> Fst:
    """Append ``times`` mandatory '$' (input side) before acceptance; '$' also
    self-loops on the new superfinal state."""
    f = fst.copy()
    if times <= 0:
        return f
    chain = [f.add_state() for _ in range(times)]
    for i, cs in enumerate(chain):
        if i + 1 < times:
            f.add_arc(cs, subseq_sym, EPS, 0.0, chain[i + 1])
    f.set_final(chain[-1], 0.0)
    f.add_arc(chain[-1], subseq_sym, EPS, 0.0, chain[-1])
    for s in range(len(f.finals)):
        if s in chain:
            continue
        if f.finals[s] != ZERO:
            f.add_arc(s, subseq_sym, EPS, f.finals[s], chain[0])
            f.finals[s] = ZERO
    return f


class IlabelInfo:
    """Grows the ilabel table during composition."""

    def __init__(self):
        self.entries: list[tuple] = [()]
        self._index: dict[tuple, int] = {(): 0}

    def id(self, entry: tuple) -> int:
        if entry not in self._index:
            self._index[entry] = len(self.entries)
            self.entries.append(entry)
        return self._index[entry]


def compose_context(lg: Fst, phones: set, disambig_syms: set,
                    context_width: int = 3, central_position: int = 1):
    """Returns (CLG fst, ilabel_info list).  ``lg`` input labels must be
    phones/disambig symbols."""
    n, p = context_width, central_position
    if n == 1:
        info = IlabelInfo()
        out = lg.copy()
        for s in out.states():
            for a in out.arcs[s]:
                if a.ilabel == EPS:
                    continue
                if a.ilabel in disambig_syms:
                    a.ilabel = info.id((-a.ilabel,))
                else:
                    a.ilabel = info.id((a.ilabel,))
        return out, info.entries

    if not (n == 3 and p == 1):
        raise NotImplementedError("context composition supports N=1 or N=3/P=1")

    subseq = max(list(phones) + list(disambig_syms)) + 1
    lg = add_subsequential_loop(lg, subseq, times=n - p - 1)
    info = IlabelInfo()

    out = Fst()
    FLUSHED = ("$",)
    state_map: dict[tuple, int] = {}
    stack = []

    def get_state(key) -> int:
        if key not in state_map:
            state_map[key] = out.add_state()
            stack.append(key)
        return state_map[key]

    if lg.start == NO_STATE_ID:
        return out, info.entries
    out.set_start(get_state(((), lg.start)))

    while stack:
        key = stack.pop()
        hist, ls = key
        s = state_map[key]
        if lg.finals[ls] != ZERO and (hist == () or hist == FLUSHED):
            out.set_final(s, lg.finals[ls])
        for a in lg.arcs[ls]:
            y = a.ilabel
            if y == EPS:
                ns = get_state((hist, a.nextstate))
                out.add_arc(s, EPS, a.olabel, a.weight, ns)
            elif y in disambig_syms:
                ns = get_state((hist, a.nextstate))
                out.add_arc(s, info.id((-y,)), a.olabel, a.weight, ns)
            elif y == subseq:
                if hist == FLUSHED or hist == ():
                    ns = get_state((FLUSHED, a.nextstate))
                    out.add_arc(s, EPS, a.olabel, a.weight, ns)
                elif len(hist) == 1:
                    il = info.id((0, hist[0], 0))
                    ns = get_state((FLUSHED, a.nextstate))
                    out.add_arc(s, il, a.olabel, a.weight, ns)
                else:  # len 2
                    il = info.id((hist[0], hist[1], 0))
                    ns = get_state((FLUSHED, a.nextstate))
                    out.add_arc(s, il, a.olabel, a.weight, ns)
            else:  # real phone
                if hist == FLUSHED:
                    raise ValueError("phone after subsequential symbol")
                if hist == ():
                    ns = get_state(((y,), a.nextstate))
                    out.add_arc(s, EPS, a.olabel, a.weight, ns)
                elif len(hist) == 1:
                    il = info.id((0, hist[0], y))
                    ns = get_state(((hist[0], y), a.nextstate))
                    out.add_arc(s, il, a.olabel, a.weight, ns)
                else:
                    il = info.id((hist[0], hist[1], y))
                    ns = get_state(((hist[1], y), a.nextstate))
                    out.add_arc(s, il, a.olabel, a.weight, ns)
    out.connect()
    return out, info.entries

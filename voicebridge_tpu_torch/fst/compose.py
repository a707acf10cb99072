"""Weighted FST composition with the standard epsilon filter.

Counterpart of OpenFst compose / Kaldi ``fsttablecompose``
(``fstext/table-matcher.h:53-340``): table-compose is a matcher optimization,
not a semantic change, so one implementation covers both call sites
(LG = L_disambig . G, HCLGa = Ha . CLG, per-utterance training graphs).

Uses the 3-way epsilon-sequencing filter to avoid duplicate eps paths; arcs of
the right-hand FST should be ilabel-sorted (we sort defensively).
"""

from __future__ import annotations

from .core import EPS, Fst, NO_STATE_ID, ZERO


def compose(fst1: Fst, fst2: Fst, connect: bool = True) -> Fst:
    """Compose two tropical-weight FSTs; output labels of fst1 match input
    labels of fst2."""
    if fst1.start == NO_STATE_ID or fst2.start == NO_STATE_ID:
        return Fst()

    # Right side arcs grouped by ilabel for binary-search matching.
    import bisect

    sorted2: list[tuple[list[int], list]] = []
    for s2 in fst2.states():
        arcs = sorted(fst2.arcs[s2], key=lambda a: a.ilabel)
        sorted2.append(([a.ilabel for a in arcs], arcs))

    out = Fst()
    # filter state: 0 = no pending eps preference, 1 = took eps on fst1 side,
    # 2 = took eps on fst2 side (standard epsilon-sequencing filter)
    state_map: dict[tuple[int, int, int], int] = {}
    stack: list[tuple[int, int, int]] = []

    def get_state(key) -> int:
        if key not in state_map:
            state_map[key] = out.add_state()
            stack.append(key)
        return state_map[key]

    start_key = (fst1.start, fst2.start, 0)
    out.set_start(get_state(start_key))

    while stack:
        key = stack.pop()
        s1, s2, fs = key
        s = state_map[key]
        f1, f2 = fst1.finals[s1], fst2.finals[s2]
        if f1 != ZERO and f2 != ZERO:
            out.set_final(s, f1 + f2)
        labels2, arcs2 = sorted2[s2]

        for a1 in fst1.arcs[s1]:
            if a1.olabel == EPS:
                # eps-output on left: move only left (filter forbids after fs==2)
                if fs != 2:
                    ns = get_state((a1.nextstate, s2, 1))
                    out.add_arc(s, a1.ilabel, EPS, a1.weight, ns)
                # simultaneous eps:eps move (both sides advance), only from
                # filter state 0 — required so eps runs on both sides compose
                if fs == 0:
                    lo = bisect.bisect_left(labels2, EPS)
                    hi = bisect.bisect_right(labels2, EPS)
                    for a2 in arcs2[lo:hi]:
                        ns = get_state((a1.nextstate, a2.nextstate, 0))
                        out.add_arc(s, a1.ilabel, a2.olabel,
                                    a1.weight + a2.weight, ns)
            else:
                lo = bisect.bisect_left(labels2, a1.olabel)
                hi = bisect.bisect_right(labels2, a1.olabel)
                for a2 in arcs2[lo:hi]:
                    ns = get_state((a1.nextstate, a2.nextstate, 0))
                    out.add_arc(s, a1.ilabel, a2.olabel, a1.weight + a2.weight, ns)
        # eps-input on right: move only right (forbidden after fs==1)
        if fs != 1:
            lo = bisect.bisect_left(labels2, EPS)
            hi = bisect.bisect_right(labels2, EPS)
            for a2 in arcs2[lo:hi]:
                ns = get_state((s1, a2.nextstate, 2))
                out.add_arc(s, EPS, a2.olabel, a2.weight, ns)

    if connect:
        out.connect()
    return out

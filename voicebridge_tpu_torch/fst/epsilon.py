"""Epsilon removal: full (fstrmepsilon) and local (fstrmepslocal).

``remove_eps_local`` mirrors Kaldi ``RemoveEpsLocal`` (``fstext/remove-eps-local.h``)
in spirit: remove eps:eps arcs only where it cannot blow up the machine
(in-degree-1 targets / single-arc sources).  Remaining eps arcs are harmless —
the TPU decoder treats them as non-emitting arcs.  ``rm_epsilon`` is the full
closure-based removal for small graphs (L for G2P, tests).
"""

from __future__ import annotations

import heapq

from .core import EPS, Fst, NO_STATE_ID, ZERO, trop_plus


def rm_epsilon(fst: Fst) -> Fst:
    """Full input/output-eps (eps:eps only) removal via per-state tropical
    eps-closure.  Arcs that are eps on only one side are kept."""
    if fst.start == NO_STATE_ID:
        return fst.copy()
    n = fst.num_states
    out = Fst()
    out.add_states(n)
    out.set_start(fst.start)

    for s in range(n):
        # dijkstra over eps:eps arcs
        dist = {s: 0.0}
        heap = [(0.0, s)]
        closed = set()
        while heap:
            d, u = heapq.heappop(heap)
            if u in closed:
                continue
            closed.add(u)
            for a in fst.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    nd = d + a.weight
                    if nd < dist.get(a.nextstate, ZERO) - 1e-12:
                        dist[a.nextstate] = nd
                        heapq.heappush(heap, (nd, a.nextstate))
        fin = ZERO
        seen_arcs = {}
        for u, d in dist.items():
            if fst.finals[u] != ZERO:
                fin = trop_plus(fin, d + fst.finals[u])
            for a in fst.arcs[u]:
                if a.ilabel == EPS and a.olabel == EPS:
                    continue
                key = (a.ilabel, a.olabel, a.nextstate)
                w = d + a.weight
                if key not in seen_arcs or w < seen_arcs[key]:
                    seen_arcs[key] = w
        for (il, ol, ns), w in seen_arcs.items():
            out.add_arc(s, il, ol, w, ns)
        if fin != ZERO:
            out.set_final(s, fin)
    out.connect()
    return out


def remove_eps_local(fst: Fst) -> Fst:
    """Conservative local eps:eps arc elimination (size-safe), repeated to
    fixpoint:

    * if an eps arc ``s -e-> d`` is the *only* incoming arc of ``d`` and
      ``d != start``, merge ``d`` into ``s`` (redirect d's arcs/final);
    * if ``s``'s only outgoing arc is an eps arc and ``s`` is not final and not
      start-special, splice ``s`` forward.
    """
    f = fst.copy()
    changed = True
    while changed:
        changed = False
        n = f.num_states
        indeg = [0] * n
        for s in range(n):
            for a in f.arcs[s]:
                indeg[a.nextstate] += 1
        for s in range(n):
            arcs = f.arcs[s]
            for i, a in enumerate(arcs):
                if a.ilabel != EPS or a.olabel != EPS:
                    continue
                d = a.nextstate
                if d == s:
                    if a.weight >= 0.0:  # non-negative eps self-loop: useless
                        arcs.pop(i)
                        changed = True
                        break
                    continue
                # case 1: d has in-degree 1 and is not the start state: absorb
                if indeg[d] == 1 and d != f.start:
                    arcs.pop(i)
                    for b in f.arcs[d]:
                        f.add_arc(s, b.ilabel, b.olabel, a.weight + b.weight, b.nextstate)
                    if f.finals[d] != ZERO:
                        nf = a.weight + f.finals[d]
                        f.finals[s] = trop_plus(f.finals[s], nf)
                    f.arcs[d] = []
                    f.finals[d] = ZERO
                    changed = True
                    break
                # case 2: s's only arc is this eps arc and s not final: splice
                if len(arcs) == 1 and f.finals[s] == ZERO and s != f.start:
                    # redirect all incoming arcs of s to d with adjusted weight
                    for u in range(n):
                        for b in f.arcs[u]:
                            if b.nextstate == s:
                                b.nextstate = d
                                b.weight += a.weight
                    arcs.pop(i)
                    changed = True
                    break
            if changed:
                break
    f.connect()
    return f

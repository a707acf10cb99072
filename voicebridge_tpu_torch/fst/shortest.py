"""Shortest distance / shortest path over the tropical semiring.

Used by the G2P phoneticizer (reference: ``PhonetisaurusScript.h`` shortest
path), lattice best-path equivalents, and tests.  Handles negative-weight-free
graphs with Dijkstra and falls back to Bellman-Ford iterations when negative
arc costs are present (pron-probs can be mildly negative after scaling).
"""

from __future__ import annotations

import heapq

from .core import EPS, Fst, NO_STATE_ID, ZERO


def shortest_distance(fst: Fst, reverse: bool = False) -> list[float]:
    """Tropical shortest distance from start (or to finals if ``reverse``)."""
    n = fst.num_states
    dist = [ZERO] * n
    if fst.start == NO_STATE_ID:
        return dist
    if reverse:
        radj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for s in range(n):
            for a in fst.arcs[s]:
                radj[a.nextstate].append((s, a.weight))
        heap = []
        for s in range(n):
            if fst.finals[s] != ZERO:
                dist[s] = fst.finals[s]
                heapq.heappush(heap, (dist[s], s))
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist[u] + 1e-12:
                continue
            for p, w in radj[u]:
                nd = d + w
                if nd < dist[p] - 1e-12:
                    dist[p] = nd
                    heapq.heappush(heap, (nd, p))
        return dist
    dist[fst.start] = 0.0
    heap = [(0.0, fst.start)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u] + 1e-12:
            continue
        for a in fst.arcs[u]:
            nd = d + a.weight
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                heapq.heappush(heap, (nd, a.nextstate))
    return dist


def shortest_path(fst: Fst) -> tuple[list[int], list[int], float]:
    """Single shortest path: returns (ilabels, olabels, total_cost), epsilons
    stripped from the label sequences."""
    n = fst.num_states
    if fst.start == NO_STATE_ID:
        return [], [], ZERO
    dist = [ZERO] * n
    back: list[tuple[int, int] | None] = [None] * n  # (prev_state, arc_idx)
    dist[fst.start] = 0.0
    heap = [(0.0, fst.start)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u] + 1e-12:
            continue
        for i, a in enumerate(fst.arcs[u]):
            nd = d + a.weight
            if nd < dist[a.nextstate] - 1e-12:
                dist[a.nextstate] = nd
                back[a.nextstate] = (u, i)
                heapq.heappush(heap, (nd, a.nextstate))
    best, best_cost = NO_STATE_ID, ZERO
    for s in range(n):
        if fst.finals[s] != ZERO and dist[s] != ZERO:
            total = dist[s] + fst.finals[s]
            if total < best_cost:
                best, best_cost = s, total
    if best == NO_STATE_ID:
        return [], [], ZERO
    ilabels: list[int] = []
    olabels: list[int] = []
    s = best
    while back[s] is not None:
        p, i = back[s]
        a = fst.arcs[p][i]
        if a.ilabel != EPS:
            ilabels.append(a.ilabel)
        if a.olabel != EPS:
            olabels.append(a.olabel)
        s = p
    return ilabels[::-1], olabels[::-1], best_cost


def nshortest_paths(fst: Fst, n: int, max_expansions: int = 200000):
    """N best distinct paths (ilabels, olabels, cost), by A*-style expansion
    with the reverse shortest distance as an exact heuristic."""
    if fst.start == NO_STATE_ID:
        return []
    h = shortest_distance(fst, reverse=True)
    results = []
    heap = [(h[fst.start] if h[fst.start] != ZERO else ZERO, 0.0, fst.start, (), ())]
    expansions = 0
    while heap and len(results) < n and expansions < max_expansions:
        est, cost, s, ilab, olab = heapq.heappop(heap)
        expansions += 1
        if est == ZERO:
            continue
        if fst.finals[s] != ZERO:
            results.append((list(ilab), list(olab), cost + fst.finals[s]))
            # keep exploring for more paths
        for a in fst.arcs[s]:
            if h[a.nextstate] == ZERO:
                continue
            ncost = cost + a.weight
            ni = ilab + ((a.ilabel,) if a.ilabel != EPS else ())
            no = olab + ((a.olabel,) if a.olabel != EPS else ())
            heapq.heappush(heap, (ncost + h[a.nextstate], ncost, a.nextstate, ni, no))
    return results

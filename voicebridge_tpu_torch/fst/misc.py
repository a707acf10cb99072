"""Miscellaneous WFST algorithms: topological sort, random path generation,
and recursive replacement.

Counterparts of the reference's remaining fstbin wrappers
(``kaldi-win/src/fstbin``: ``fsttopsort.cpp``, ``fstrandgen.cpp``,
``fstreplace.cpp``; OpenFst ``topsort.h`` / ``randgen.h`` / ``replace.h``).
"""

from __future__ import annotations

import math

import numpy as np

from .core import EPS, Arc, Fst, NO_STATE_ID, ZERO


def topsort(fst: Fst) -> bool:
    """Topologically renumber states in place (``fsttopsort``).

    Returns True and reorders states so every arc goes from a lower to a
    higher id if the FST is acyclic; returns False (FST untouched) if a
    cycle is reachable.  Matches OpenFst's ``TopSort`` contract.
    """
    n = fst.num_states
    if n == 0:
        return True
    # iterative DFS with colors (0=white 1=grey 2=black), postorder numbering
    color = np.zeros(n, dtype=np.int8)
    post: list[int] = []
    for root in range(n):
        if color[root] != 0:
            continue
        stack: list[tuple[int, int]] = [(root, 0)]
        color[root] = 1
        while stack:
            s, i = stack.pop()
            arcs = fst.arcs[s]
            advanced = False
            while i < len(arcs):
                ns = arcs[i].nextstate
                i += 1
                if color[ns] == 1:
                    return False  # back edge: cyclic
                if color[ns] == 0:
                    stack.append((s, i))
                    color[ns] = 1
                    stack.append((ns, 0))
                    advanced = True
                    break
            if not advanced and i >= len(arcs):
                color[s] = 2
                post.append(s)
    # reverse postorder = topological order
    order = post[::-1]
    remap = np.empty(n, dtype=np.int64)
    for new_id, old_id in enumerate(order):
        remap[old_id] = new_id
    new_arcs: list[list[Arc]] = [[] for _ in range(n)]
    new_finals = [ZERO] * n
    for old_id in range(n):
        new_arcs[remap[old_id]] = [
            Arc(a.ilabel, a.olabel, a.weight, int(remap[a.nextstate]))
            for a in fst.arcs[old_id]
        ]
        new_finals[remap[old_id]] = fst.finals[old_id]
    fst.arcs = new_arcs
    fst.finals = new_finals
    if fst.start != NO_STATE_ID:
        fst.start = int(remap[fst.start])
    return True


def randgen(fst: Fst, npath: int = 1, seed: int = 0, weighted: bool = True,
            max_length: int = 10_000) -> Fst:
    """Sample ``npath`` random successful paths (``fstrandgen``).

    With ``weighted=True`` arcs (and stopping at a final state) are chosen
    with probability proportional to ``exp(-cost)``; otherwise uniformly.
    Returns the union of the sampled paths as a new FST (each path is a
    separate linear branch from a common start state, like OpenFst's
    ``RandGen`` output).
    """
    rng = np.random.default_rng(seed)
    out = Fst()
    root = out.add_state()
    out.set_start(root)
    if fst.start == NO_STATE_ID:
        return out
    for _ in range(npath):
        cur_out = root
        s = fst.start
        for _step in range(max_length):
            choices = list(fst.arcs[s])
            stop_cost = fst.finals[s]
            if weighted:
                costs = [a.weight for a in choices]
                if stop_cost != ZERO:
                    costs.append(stop_cost)
                if not costs or min(costs) == ZERO:
                    break  # dead end (or all-infinite costs): drop path
                w = np.exp(-(np.asarray(costs) - min(costs)))
                p = w / w.sum()
                k = int(rng.choice(len(costs), p=p))
            else:
                nopt = len(choices) + (1 if stop_cost != ZERO else 0)
                if nopt == 0:
                    break
                k = int(rng.integers(nopt))
            if k == len(choices):  # chose to stop at a final state
                out.set_final(cur_out, stop_cost)
                break
            a = choices[k]
            nxt = out.add_state()
            out.add_arc(cur_out, a.ilabel, a.olabel, a.weight, nxt)
            cur_out = nxt
            s = a.nextstate  # path weight rides on the copied arcs
        else:
            if fst.finals[s] != ZERO:
                out.set_final(cur_out, fst.finals[s])
    return out.connect()


def replace(root: Fst, replacements: dict[int, Fst],
            epsilon_on_replace: bool = True) -> Fst:
    """Recursively expand nonterminal output labels (``fstreplace``).

    ``replacements`` maps a nonterminal label id to the FST that replaces
    arcs carrying that label (matched on the *output* label, as OpenFst's
    default).  Expansion is static (the reference only uses small grammars):
    each nonterminal arc is replaced by a copy of its definition FST wired
    between the arc's endpoints; definitions may reference each other but
    not cyclically.
    """

    def expand(f: Fst, active: frozenset[int]) -> Fst:
        out = Fst()
        out.add_states(f.num_states)
        out.start = f.start
        for s in range(f.num_states):
            out.finals[s] = f.finals[s]
        for s in range(f.num_states):
            for a in f.arcs[s]:
                if a.olabel in replacements:
                    if a.olabel in active:
                        raise ValueError(
                            f"cyclic nonterminal reference: {a.olabel}")
                    sub = expand(replacements[a.olabel],
                                 active | {a.olabel})
                    if sub.start == NO_STATE_ID:
                        continue
                    off = out.add_states(sub.num_states)
                    # REPLACE_LABEL_NEITHER semantics: with epsilon_on_replace
                    # the call arc consumes nothing on the input side
                    ilab = EPS if epsilon_on_replace else a.ilabel
                    olab = EPS
                    out.add_arc(s, ilab, olab, a.weight, off + sub.start)
                    for ss in range(sub.num_states):
                        for sa in sub.arcs[ss]:
                            out.add_arc(off + ss, sa.ilabel, sa.olabel,
                                        sa.weight, off + sa.nextstate)
                        if sub.finals[ss] != ZERO:
                            out.add_arc(off + ss, EPS, EPS, sub.finals[ss],
                                        a.nextstate)
                else:
                    out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
        return out

    return expand(root, frozenset()).connect()

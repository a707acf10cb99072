"""PushSpecial: reweight so every state's outgoing probability mass is the
same constant, without changing path weights' total distribution.

Counterpart of Kaldi ``fstpushspecial`` (``fstext/push-special.h``), applied to
LG in mkgraph (``scr/utils/mkgraph.cpp:79-99``).  Standard weight pushing would
move all mass to the start; PushSpecial instead equalizes the per-state
"leftover" lambda via power iteration on the probability adjacency matrix
(dominant eigenvector v, eigenvalue lambda):

    w'(s -> d) = w(s,d) * v[d] / (lambda * v[s])

so each state's outgoing sum becomes lambda (uniform residue), which is what
the decoder's beam pruning wants.
"""

from __future__ import annotations

import math

import numpy as np

from .core import Fst, NO_STATE_ID, ZERO


def push_special(fst: Fst, delta: float = 1e-4, max_iters: int = 2000) -> Fst:
    if fst.start == NO_STATE_ID or fst.num_states == 0:
        return fst.copy()
    f = fst.copy()
    n = f.num_states

    # probability-domain sparse adjacency (finals act as arcs to a virtual
    # "super final" state that redistributes to start, closing the chain as in
    # Kaldi's formulation)
    rows, cols, vals = [], [], []
    for s in range(n):
        for a in f.arcs[s]:
            rows.append(s)
            cols.append(a.nextstate)
            vals.append(math.exp(-a.weight))
        if f.finals[s] != ZERO:
            rows.append(s)
            cols.append(f.start)
            vals.append(math.exp(-f.finals[s]))
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)

    v = np.ones(n, dtype=np.float64)
    lam = 1.0
    for _ in range(max_iters):
        # v_new[s] = sum_arcs p(s->d) v[d]
        nv = np.zeros(n, dtype=np.float64)
        np.add.at(nv, rows, vals * v[cols])
        norm = nv.max()
        if norm <= 0:
            break
        nv /= norm
        if np.abs(nv - v).max() < delta:
            v, lam = nv, norm
            break
        v, lam = nv, norm

    v = np.maximum(v, 1e-20)
    loglam = math.log(lam)
    logv = np.log(v)
    for s in range(n):
        for a in f.arcs[s]:
            a.weight = a.weight - logv[a.nextstate] + logv[s] + loglam
        if f.finals[s] != ZERO:
            f.finals[s] = f.finals[s] - logv[f.start] + logv[s] + loglam
    return f

"""The comparisons that decide ``correct``: what the timed path produced,
held to the plain references in float64.  Imports nothing of the program:
the program's outputs arrive as arrays.

Decode (``lattice_numbers``): each sampled utterance's lattice as arrays of
its surviving arcs' frames, arc ids and acoustic costs.
Training (``alignment_gap``, ``leaf_error``): alignments as transition ids
per frame; statistics and models as arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import align as RA
from .reference import lattice as RL


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference of two tensors on one device."""
    d = a.double() - b.double()
    return float(d.abs().max()) if d.numel() else 0.0


def lattice_numbers(graph: dict, ll64: torch.Tensor, acwt: float, beam: float,
                    lattices: list, block: int = 16) -> dict:
    """``ll64 [n, T, P]`` the reference's log-likelihoods of n utterances of
    T frames; ``lattices[i] = (frame [k], arc [k], acoustic cost [k])``.

    * ``cost_err``: the largest gap between a surviving arc's acoustic cost
      and the reference's -log-likelihood of its frame and pdf;
    * ``lat_miss``: the largest distance from the beam's edge of an arc on
      which the lattice and the reference disagree (a survivor the
      reference prunes, or the reference's survivor missing), in units of
      score; 0 where they agree, inf where a lattice holds no arc."""
    dev = ll64.device
    pdf = torch.as_tensor(graph["pdf"], device=dev).long()
    a = len(graph["src"])
    n, t_total, _ = ll64.shape
    cost_err, miss = 0.0, 0.0
    for i, (ft, arc, cost) in enumerate(lattices):
        if len(arc) == 0:
            return {"cost_err": math.inf, "lat_miss": math.inf}
        ft = torch.as_tensor(np.asarray(ft), device=dev).long()
        arc = torch.as_tensor(np.asarray(arc), device=dev).long()
        want = -ll64[i, ft, pdf[arc]]
        cost_err = max(cost_err, max_abs(torch.as_tensor(np.asarray(cost), device=dev), want))
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        lane = torch.cat([torch.full((len(lattices[i][1]),), i - lo, device=dev, dtype=torch.long)
                          for i in range(lo, hi)])
        ft = torch.cat([torch.as_tensor(np.asarray(lattices[i][0]), device=dev).long()
                        for i in range(lo, hi)])
        arc = torch.cat([torch.as_tensor(np.asarray(lattices[i][1]), device=dev).long()
                         for i in range(lo, hi)])
        order = torch.argsort(ft, stable=True)
        lane, ft, arc = lane[order], ft[order], arc[order]
        bounds = torch.searchsorted(ft, torch.arange(t_total + 1, device=dev)).tolist()
        worst = torch.zeros((), dtype=torch.float64, device=dev)

        def visit(t, margin):
            nonlocal worst
            got = torch.zeros((hi - lo, a), dtype=torch.bool, device=dev)
            got[lane[bounds[t]:bounds[t + 1]], arc[bounds[t]:bounds[t + 1]]] = True
            wrong = got ^ (margin >= 0)
            if bool(wrong.any()):
                worst = torch.maximum(worst, margin[wrong].abs().max())

        RL.forward_backward(graph, ll64[lo:hi], acwt, beam, visit=visit)
        miss = max(miss, float(worst))
    return {"cost_err": cost_err, "lat_miss": miss}


def leaf_error(got: np.ndarray, want: np.ndarray) -> float:
    """The worst pdf's relative error: per pdf (first axis) the norm of the
    difference over the larger of the reference's norm for that pdf and the
    median pdf's."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    if got.shape != want.shape:
        return math.inf
    norms = np.linalg.norm(want, axis=1)
    scale = np.maximum(norms, max(float(np.median(norms)), 1e-300))
    return float((np.linalg.norm(got - want, axis=1) / scale).max())


def alignment_gap(w: torch.Tensor, emit: torch.Tensor, kinds: torch.Tensor,
                  num_frames: torch.Tensor, num_states: torch.Tensor) -> float:
    """The largest amount by which an alignment's score lies below the
    best path's, both in float64 on the reference's scores (inf where the
    alignment is no path of its graph)."""
    best = RA.best_scores(w, emit, num_frames, num_states)
    got = RA.path_scores(w, emit, kinds, num_frames, num_states)
    return float((best - got).max())

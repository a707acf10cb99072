"""Plain lattice forward-backward over a shared decode graph (Kaldi's
lattice generation with exact search and ``--lattice-beam``), arc by arc in
plain torch.  Imports nothing of the program.

The graph is a dict of arrays: ``src``, ``dst``, ``pdf``, ``score`` per arc
(score = -graph cost), ``alpha0`` and ``final`` per state (-inf where not a
start or final state).  An arc emitted at frame t survives when the best
complete path through it,

    alpha_t[src] + score + acwt * ll[t, pdf] + beta_{t+1}[dst],

lies within the lattice beam of the best complete path.  ``alpha_t`` is the
best score of t frames ending in a state (``alpha_0 = alpha0``), ``beta``
the best score from a state at frame t to the end, ``beta_T = final`` when
some final state is reached at the end and 0 otherwise (a partial path).
"""

from __future__ import annotations

import math

import torch

from .precision import EXACT, Precision


def _scatter_max(values: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, A]`` values -> ``[B, size]`` maxima over equal ``index``."""
    out = torch.full((values.shape[0], size), -math.inf, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(1, index[None].expand_as(values), values, "amax",
                              include_self=True)


def forward_backward(graph: dict, ll: torch.Tensor, acwt: float, beam: float,
                     prec: Precision = EXACT, visit=None, every: int = 32):
    """``ll [B, T, P]`` log-likelihoods of B utterances of T frames each.
    Calls ``visit(t, margin [B, A])`` for every frame t, where margin is the
    best complete path through each arc minus (best - beam): an arc
    survives where margin >= 0.  Returns the best complete scores ``[B]``.
    The forward keeps ``alpha_t`` of every ``every``-th frame and the
    backward works them out again a stretch at a time, so memory holds
    about ``T / every + every`` of them."""
    dev = ll.device
    src = torch.as_tensor(graph["src"], device=dev).long()
    dst = torch.as_tensor(graph["dst"], device=dev).long()
    pdf = torch.as_tensor(graph["pdf"], device=dev).long()
    score = prec.t(torch.as_tensor(graph["score"])).to(dev)
    s = len(graph["alpha0"])
    b, t_total, _ = ll.shape
    am = prec.t(ll) * prec.t(acwt)

    def step(alpha, t):
        return _scatter_max(alpha[:, src] + score + am[:, t, pdf], dst, s)

    alpha = prec.t(torch.as_tensor(graph["alpha0"])).to(dev)[None].expand(b, s)
    kept = {}
    for t in range(t_total):
        if t % every == 0:
            kept[t] = alpha
        alpha = step(alpha, t)
    final = prec.t(torch.as_tensor(graph["final"])).to(dev)[None]
    with_final = (alpha + final).amax(dim=1)
    use_final = with_final > -math.inf
    best = torch.where(use_final, with_final, alpha.amax(dim=1))
    beta = torch.where(use_final[:, None], final.expand(b, s), torch.zeros_like(alpha))
    cut = best - prec.t(beam)
    for lo in range(((t_total - 1) // every) * every, -1, -every):
        alphas = [kept.pop(lo)]
        for t in range(lo, min(lo + every, t_total) - 1):
            alphas.append(step(alphas[-1], t))
        for t in range(min(lo + every, t_total) - 1, lo - 1, -1):
            tail = score + am[:, t, pdf] + beta[:, dst]  # [B, A]
            if visit is not None:
                visit(t, alphas[t - lo][:, src] + tail - cut[:, None])
            beta = _scatter_max(tail, src, s)
            alphas[t - lo] = None
    return best

"""Plain Viterbi alignment over left-to-right training graphs (Kaldi's
``gmm-align-compiled`` with an infinite beam), and the score of a given
alignment on the same graph.  Imports nothing of the program.

An utterance's graph is a chain of states 0..S-1 with a pdf each: every
state has a self-loop, state j is entered from j - 1 and, where ``skip[j]``,
from j - 2; the arc into j carries j's pdf and the score of its kind
(``w[kind, j]``: 0 self-loop, 1 from j - 1, 2 from j - 2).  Paths start in
state 0 before the first frame and end in state S-1 after the last.
"""

from __future__ import annotations

import math

import torch

SELF, NEXT, SKIP = 0, 1, 2


def best_scores(w: torch.Tensor, emit: torch.Tensor, num_frames: torch.Tensor,
                num_states: torch.Tensor) -> torch.Tensor:
    """``w [B, 3, S]`` arc scores (-inf where no arc), ``emit [B, T, S]``
    scaled emission scores of each state at each frame, frame and state
    counts ``[B]`` -> the best path score of each utterance ``[B]``."""
    b, t_total, s = emit.shape
    neg = torch.full((b, 1), -math.inf, dtype=emit.dtype, device=emit.device)
    alpha = torch.cat([torch.zeros_like(neg), neg.expand(b, s - 1)], dim=1)
    for t in range(t_total):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        new = torch.maximum(torch.maximum(alpha + w[:, SELF], prev1 + w[:, NEXT]),
                            prev2 + w[:, SKIP]) + emit[:, t]
        alpha = torch.where((t < num_frames)[:, None], new, alpha)
    return alpha.gather(1, (num_states - 1).long()[:, None])[:, 0]


def path_scores(w: torch.Tensor, emit: torch.Tensor, kinds: torch.Tensor,
                num_frames: torch.Tensor, num_states: torch.Tensor) -> torch.Tensor:
    """The score of each utterance's path given as the arc kind of every
    frame (``kinds [B, T]``, frames past the end ignored); -inf where the
    path leaves the chain, takes a missing arc or ends elsewhere than the
    last state."""
    b, t_total, s = emit.shape
    live = torch.arange(t_total, device=emit.device)[None] < num_frames[:, None]
    step = torch.where(live, kinds.long(), torch.zeros_like(kinds, dtype=torch.long))
    state = torch.cumsum(step, dim=1)  # [B, T]
    inside = state < s
    st = state.clamp_max(s - 1)
    arc = w.reshape(b, 3 * s).gather(1, step * s + st)  # w[b, kind, state]
    em = emit.gather(2, st[..., None])[..., 0]
    total = torch.where(live, arc + em, torch.zeros_like(em)).sum(dim=1)
    last = state.gather(1, (num_frames - 1).clamp_min(0).long()[:, None])[:, 0]
    ok = (inside | ~live).all(dim=1) & (last == num_states - 1)
    return torch.where(ok, total, torch.full_like(total, -math.inf))


def best_paths(w: torch.Tensor, emit: torch.Tensor, num_frames: torch.Tensor,
               num_states: torch.Tensor) -> torch.Tensor:
    """The best path of each utterance as the arc kind of every frame
    (``[B, T]``, 0 past the end), from the forward's choices kept a frame
    and state and a walk back from the last state."""
    b, t_total, s = emit.shape
    neg = torch.full((b, 1), -math.inf, dtype=emit.dtype, device=emit.device)
    alpha = torch.cat([torch.zeros_like(neg), neg.expand(b, s - 1)], dim=1)
    choice = torch.zeros((t_total, b, s), dtype=torch.int8, device=emit.device)
    for t in range(t_total):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        cand = torch.stack([alpha + w[:, SELF], prev1 + w[:, NEXT], prev2 + w[:, SKIP]])
        best, arg = cand.max(dim=0)
        choice[t] = arg.to(torch.int8)
        alpha = torch.where((t < num_frames)[:, None], best + emit[:, t], alpha)
    kinds = torch.zeros((b, t_total), dtype=torch.long, device=emit.device)
    state = (num_states - 1).long()
    rows = torch.arange(b, device=emit.device)
    for t in range(t_total - 1, -1, -1):
        live = t < num_frames
        k = choice[t, rows, state].long()
        kinds[:, t] = torch.where(live, k, torch.zeros_like(k))
        state = torch.where(live, state - k, state)
    return kinds

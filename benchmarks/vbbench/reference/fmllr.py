"""Plain two-pass fMLLR decoding stages (Kaldi's ``steps/decode_fmllr.sh``:
``gmm-latgen-faster``, ``lattice-to-post``, ``weight-silence-post``,
``gmm-est-fmllr-gpost``, ``transform-feats``, ``gmm-rescore-lattice``,
``lattice-best-path``), each written from its definition in plain torch,
in float64 unless told another precision.  Imports nothing of the program:
a model, a graph and a lattice arrive as arrays.

* A GMM is a dict of arrays ``means [P, M, D]``, ``vars [P, M, D]``,
  ``weights [P, M]`` (weight 0 on an unused slot).
* A graph is a dict of arrays per arc ``src``, ``dst``, ``pdf``, ``score``
  (= -graph cost) and ``word`` (0: none), and per state ``alpha0`` and
  ``final`` (scores, -inf where not a start or final state).
* A lattice is ``(frame [k], arc [k], acoustic cost [k])`` of its arcs.

``Precision`` is the arithmetic a function runs in: ``EXACT`` is float64;
a caller may pass another object with ``dtype``, ``t(x)`` and ``mm(a, b)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Precision:
    """float64 throughout."""

    dtype = torch.float64

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a.to(self.dtype) @ b.to(self.dtype)


EXACT = Precision()


def _lse_scatter(values: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """``[n]`` values -> ``[size]`` log-sum-exp over equal ``index`` (-inf
    where none)."""
    top = torch.full((size,), -math.inf, dtype=values.dtype, device=values.device)
    top = top.scatter_reduce(0, index, values, "amax", include_self=True)
    shift = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    acc = torch.zeros_like(top).index_add_(0, index, torch.exp(values - shift[index]))
    return torch.where(acc > 0, shift + torch.log(acc), torch.full_like(acc, -math.inf))


def loglikes(gmm: dict, x: torch.Tensor, prec=EXACT, block: int = 1024) -> torch.Tensor:
    """Per-pdf log-likelihoods ``[N, P]`` of frames ``x [N, D]``: one
    product of ``[x, x^2, 1]`` with every Gaussian's ``[mean/var,
    -1/(2 var), log w - (D log 2 pi + sum(log var + mean^2/var)) / 2]``,
    then a log-sum-exp over each pdf's live slots, ``block`` frames at a
    time."""
    dev = x.device
    mean = torch.as_tensor(np.asarray(gmm["means"], np.float64), device=dev)
    var = torch.as_tensor(np.asarray(gmm["vars"], np.float64), device=dev)
    w = torch.as_tensor(np.asarray(gmm["weights"], np.float64), device=dev)
    p, m, d = mean.shape
    live = w > 0
    gc = torch.log(torch.where(live, w, torch.ones_like(w))) - 0.5 * (
        d * math.log(2 * math.pi) + (torch.log(var) + mean * mean / var).sum(2))
    cols = prec.t(torch.cat([mean / var, -0.5 / var, gc[..., None]], 2)
                  .reshape(p * m, 2 * d + 1).T)
    out = []
    for lo in range(0, len(x), block):
        xb = prec.t(x[lo:lo + block])
        rows = torch.cat([xb, xb * xb, torch.ones_like(xb[:, :1])], 1)
        comp = prec.mm(rows, cols).view(-1, p, m)
        out.append(torch.logsumexp(comp.masked_fill(~live[None], -math.inf), 2))
    return torch.cat(out) if out else torch.zeros((0, p), dtype=prec.dtype, device=dev)


def forward_backward(graph: dict, ll: torch.Tensor, acwt: float, beam: float, visit,
                     prec=EXACT, every: int = 32) -> torch.Tensor:
    """The exact lattice forward-backward with a lattice beam over ``ll [B,
    T, P]``: calls ``visit(t, margin [B, A])`` for every frame, margin the
    best complete path through each arc less (best - beam), so an arc
    survives where it is >= 0 (``beta_T`` = ``final`` where a final state
    is reached, else 0).  Returns the best complete scores ``[B]``.  The
    forward keeps every ``every``-th ``alpha``; the backward works the
    rest out again a stretch at a time."""
    dev = ll.device
    src = torch.as_tensor(graph["src"], device=dev).long()
    dst = torch.as_tensor(graph["dst"], device=dev).long()
    pdf = torch.as_tensor(graph["pdf"], device=dev).long()
    score = prec.t(graph["score"]).to(dev)
    s = len(graph["alpha0"])
    b, t_total, _ = ll.shape
    am = prec.t(ll) * prec.t(acwt)

    def relax(values, index):
        out = torch.full((b, s), -math.inf, dtype=values.dtype, device=dev)
        return out.scatter_reduce(1, index[None].expand_as(values), values, "amax",
                                  include_self=True)

    alpha = prec.t(graph["alpha0"]).to(dev)[None].expand(b, s)
    kept = {}
    for t in range(t_total):
        if t % every == 0:
            kept[t] = alpha
        alpha = relax(alpha[:, src] + score + am[:, t, pdf], dst)
    final = prec.t(graph["final"]).to(dev)[None]
    with_final = (alpha + final).amax(1)
    use_final = with_final > -math.inf
    best = torch.where(use_final, with_final, alpha.amax(1))
    beta = torch.where(use_final[:, None], final.expand(b, s), torch.zeros_like(alpha))
    cut = best - prec.t(beam)
    for lo in range(((t_total - 1) // every) * every, -1, -every):
        alphas = [kept.pop(lo)]
        for t in range(lo, min(lo + every, t_total) - 1):
            alphas.append(relax(alphas[-1][:, src] + score + am[:, t, pdf], dst))
        for t in range(min(lo + every, t_total) - 1, lo - 1, -1):
            tail = score + am[:, t, pdf] + beta[:, dst]
            visit(t, alphas[t - lo][:, src] + tail - cut[:, None])
            beta = relax(tail, src)
            alphas[t - lo] = None
    return best


def _lattice_arcs(graph: dict, lats: list, acwt: float, prec, dev):
    """Every lattice's arcs as flat tensors sorted by frame: (lane, frame,
    src, dst, arc, score = graph score - acwt * acoustic cost)."""
    lane = torch.cat([torch.full((len(a),), i, dtype=torch.long)
                      for i, (_t, a, _c) in enumerate(lats)]).to(dev)
    t, arc, cost = (torch.cat([torch.as_tensor(np.asarray(lat[k]), dtype=dtype) for lat in lats])
                    .to(dev) for k, dtype in ((0, torch.long), (1, torch.long), (2, torch.float64)))
    order = torch.argsort(t, stable=True)  # frame-major, lattices and arcs in order
    lane, t, arc, cost = lane[order], t[order], arc[order], prec.t(cost[order])
    score = prec.t(torch.as_tensor(graph["score"])).to(dev)[arc] - prec.t(acwt) * cost
    src = torch.as_tensor(graph["src"], device=dev).long()[arc]
    dst = torch.as_tensor(graph["dst"], device=dev).long()[arc]
    return lane, t, src, dst, arc, score


def lattice_posteriors(graph: dict, lats: list, num_frames: int, acwt: float,
                       silence_arc: np.ndarray, silence_weight: float, min_post: float = 0.01,
                       k_post: int = 4, prec=EXACT, device="cpu"):
    """``lattice-to-post --acoustic-scale`` then ``weight-silence-post`` of
    lattices of ``num_frames`` frames, on ``device``: arc posteriors by the
    log-semiring forward-backward over each lattice's arcs, those above
    ``min_post`` renormalized per frame, the ``k_post`` largest a frame kept
    (ties in arc order), and an arc whose ``silence_arc`` flag is set
    weighted by ``silence_weight``.  Returns (pdf ``[n, T, k_post]`` long,
    weight ``[n, T, k_post]``), weight 0 on empty slots."""
    dev = torch.device(device)
    n, s, t_total = len(lats), len(graph["alpha0"]), int(num_frames)
    lane, t, src, dst, arc, score = _lattice_arcs(graph, lats, acwt, prec, dev)
    bounds = torch.searchsorted(t, torch.arange(t_total + 1, device=dev)).tolist()
    alpha = prec.t(graph["alpha0"]).to(dev)[None].expand(n, s).reshape(-1)
    alpha_src = torch.empty_like(score)
    for f in range(t_total):
        lo, hi = bounds[f], bounds[f + 1]
        a_src = alpha[lane[lo:hi] * s + src[lo:hi]]
        alpha_src[lo:hi] = a_src
        alpha = _lse_scatter(a_src + score[lo:hi], lane[lo:hi] * s + dst[lo:hi], n * s)
    beta = prec.t(graph["final"]).to(dev)[None].expand(n, s).reshape(-1)
    total = torch.logsumexp((alpha + beta).view(n, s), 1)
    post = torch.empty_like(score)
    for f in range(t_total - 1, -1, -1):
        lo, hi = bounds[f], bounds[f + 1]
        tail = score[lo:hi] + beta[lane[lo:hi] * s + dst[lo:hi]]
        post[lo:hi] = torch.exp(alpha_src[lo:hi] + tail - total[lane[lo:hi]])
        beta = _lse_scatter(tail, lane[lo:hi] * s + src[lo:hi], n * s)
    keep = post > min_post
    cell = (lane * t_total + t)[keep]
    arc, post = arc[keep], post[keep]
    z = torch.zeros(n * t_total, dtype=post.dtype, device=dev).index_add_(0, cell, post)
    post = post / z[cell]
    order = torch.argsort(-post, stable=True)
    order = order[torch.argsort(cell[order], stable=True)]  # by cell, falling posterior
    cell, arc, post = cell[order], arc[order], post[order]
    rank = torch.arange(len(cell), device=dev) - torch.searchsorted(cell, cell)
    top = rank < k_post
    sil = torch.as_tensor(np.asarray(silence_arc), device=dev)[arc]
    weight = post * torch.where(sil, prec.t(silence_weight).to(dev), prec.t(1.0).to(dev))
    pdf_out = torch.zeros((n * t_total, k_post), dtype=torch.long, device=dev)
    w_out = torch.zeros((n * t_total, k_post), dtype=prec.dtype, device=dev)
    pdf_out[cell[top], rank[top]] = torch.as_tensor(graph["pdf"], device=dev).long()[arc[top]]
    w_out[cell[top], rank[top]] = weight[top]
    return pdf_out.view(n, t_total, k_post), w_out.view(n, t_total, k_post)


def fmllr_stats(gmm: dict, x: torch.Tensor, pdf: torch.Tensor, weight: torch.Tensor,
                prec=EXACT):
    """One speaker's fMLLR statistics (``gmm-est-fmllr-gpost``'s
    accumulation) from posterior entries: frames ``x [N, D]``, each with
    ``pdf [N, K]`` and ``weight [N, K]``.  Each entry's weight is spread
    over its pdf's Gaussians by their posteriors given the frame, then
    beta = sum g, K[d] = sum g mu_d / var_d [x; 1], G[d] = sum g / var_d
    [x; 1] [x; 1]^T.  Returns (beta, K [D, D+1], G [D, D+1, D+1])."""
    dev = x.device
    mean = prec.t(np.asarray(gmm["means"], np.float64)).to(dev)
    var = prec.t(np.asarray(gmm["vars"], np.float64)).to(dev)
    w = torch.as_tensor(np.asarray(gmm["weights"], np.float64), device=dev)
    k = pdf.shape[1]
    live = weight.reshape(-1) != 0
    rows = torch.arange(len(x), device=dev).repeat_interleave(k)[live]
    p = pdf.reshape(-1)[live]
    wt = prec.t(weight.reshape(-1)[live])
    xr = prec.t(x)[rows]  # [E, D]
    mu, vr, ww = mean[p], var[p], w[p]  # [E, M, D], [E, M]
    ll = torch.log(torch.where(ww > 0, ww, torch.ones_like(ww))).to(prec.dtype) - 0.5 * (
        math.log(2 * math.pi) * x.shape[1]
        + (torch.log(vr) + (xr[:, None] - mu) ** 2 / vr).sum(2))
    ll = ll.masked_fill(ww <= 0, -math.inf)
    g = torch.softmax(ll, 1) * wt[:, None]  # [E, M]
    a = torch.einsum("em,emd->ed", g, mu / vr)
    b = torch.einsum("em,emd->ed", g, 1.0 / vr)
    xh = torch.cat([xr, torch.ones_like(xr[:, :1])], 1)
    return (g.sum(), prec.mm(a.T, xh), torch.einsum("ed,ei,ej->dij", b, xh, xh))


def fmllr_solve(beta: float, k: torch.Tensor, g: torch.Tensor, min_count: float = 500.0,
                num_iters: int = 20) -> torch.Tensor:
    """Kaldi's full fMLLR update (``FmllrInnerUpdate``), row by row from the
    identity: row i becomes ``alpha G_i^-1 c_i + G_i^-1 k_i``, c_i the i-th
    cofactor row of A, alpha the positive root of the quadratic in beta,
    the row's objective; each G_i regularized by 1e-5 of its mean diagonal;
    at most ``num_iters`` sweeps, stopping once the objective moves by less
    than 1e-6 of itself.  The identity below ``min_count`` frames.  Returns
    W ``[D, D+1]`` in float64."""
    k, g = k.double(), g.double()
    d = k.shape[0]
    w = torch.cat([torch.eye(d, dtype=torch.float64, device=k.device),
                   torch.zeros((d, 1), dtype=torch.float64, device=k.device)], 1)
    beta = float(beta)
    if beta < min_count:
        return w
    eye = torch.eye(d + 1, dtype=torch.float64, device=k.device)
    tr = torch.diagonal(g, dim1=1, dim2=2).sum(1) / (d + 1)
    ginv = torch.linalg.inv(g + 1e-5 * tr.clamp_min(1e-10)[:, None, None] * eye)
    gk = torch.einsum("def,df->de", ginv, k)

    def objf(ww):
        sign, logdet = torch.linalg.slogdet(ww[:, :d])
        quad = (ww * k).sum() - 0.5 * torch.einsum("de,def,df->", ww, g, ww)
        return float(beta * (logdet if sign > 0 else -math.inf) + quad)

    prev = objf(w)
    for _ in range(num_iters):
        for i in range(d):
            a = w[:, :d]
            cof = torch.linalg.det(a) * torch.linalg.inv(a).T[i]
            c = torch.cat([cof, cof.new_zeros(1)])
            gc = ginv[i] @ c
            c1, c2 = float(c @ gc), float(c @ gk[i])
            if c1 <= 0:
                continue
            step = (-c2 + math.sqrt(max(c2 * c2 + 4.0 * beta * c1, 0.0))) / (2.0 * c1)
            w[i] = gk[i] + step * gc
        cur = objf(w)
        done = cur - prev < 1e-6 * max(abs(prev), 1.0)
        prev = cur
        if done:
            break
    return w


def apply_transform(w: torch.Tensor, x: torch.Tensor, prec=EXACT) -> torch.Tensor:
    """``transform-feats``: ``x [..., D] -> A x + b`` with ``W = [A, b]``."""
    w = prec.t(w).to(x.device)
    flat = prec.t(x).reshape(-1, x.shape[-1])
    return (prec.mm(flat, w[:, :-1].T) + w[:, -1]).view(*x.shape[:-1], w.shape[0])


def best_path(graph: dict, lat: tuple, num_frames: int, acwt: float, prec=EXACT):
    """``lattice-best-path`` of one lattice: the best path over its arcs,
    frame by frame (score = graph score - acwt * acoustic cost, from the
    start scores, ending with the final scores where a final state is
    reached), over the states its arcs touch.  Returns (score, word ids)."""
    dev = torch.device("cpu")
    _lane, t, src, dst, arc, score = _lattice_arcs(graph, [lat], acwt, prec, dev)
    states, idx = torch.unique(torch.cat([src, dst]), return_inverse=True)
    src_c, dst_c = idx[:len(src)], idx[len(src):]
    s, t_total = len(states), int(num_frames)
    bounds = torch.searchsorted(t, torch.arange(t_total + 1)).tolist()
    alpha = prec.t(graph["alpha0"])[states]
    choice = []
    for f in range(t_total):
        lo, hi = bounds[f], bounds[f + 1]
        cand = alpha[src_c[lo:hi]] + score[lo:hi]
        alpha = torch.full((s,), -math.inf, dtype=prec.dtype).scatter_reduce(
            0, dst_c[lo:hi], cand, "amax", include_self=True)
        into = {}
        for j in torch.nonzero(cand == alpha[dst_c[lo:hi]]).squeeze(1).tolist():
            into.setdefault(int(dst_c[lo + j]), lo + j)  # the first arc of the best score
        choice.append(into)
    end = alpha + prec.t(graph["final"])[states]
    if not bool(torch.isfinite(end).any()):
        end = alpha
    state = int(torch.argmax(end))
    total = float(end[state])
    words = []
    for f in range(t_total - 1, -1, -1):
        j = choice[f][state]
        word = int(graph["word"][int(arc[j])])
        if word:
            words.append(word)
        state = int(src_c[j])
    return total, words[::-1]

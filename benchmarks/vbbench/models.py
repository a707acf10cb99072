"""Models and graphs drawn from the run's seed, on the run's device, in a
few large calls, then handed to the program and the reference alike.

A GMM is a dict of numpy float64 arrays ``means [P, M, D]``, ``vars`` and
``weights [P, M]`` (weight 0 on unused slots, ``M`` a power of two), the
layout of the plain references; ``to_am`` gives the program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .traffic import fixed_set, uniform


def allot(share: np.ndarray, total: int, power: float) -> np.ndarray:
    """Gaussians per pdf in proportion to ``share ** power``, at least one
    each, summing to ``total`` (largest remainders first), as mixing up to
    ``total`` spreads them."""
    score = share ** power
    raw = score / score.sum() * total
    n = np.maximum(np.floor(raw).astype(np.int64), 1)
    rest = total - int(n.sum())
    order = np.argsort(-(raw - np.floor(raw)), kind="stable")
    n[order[:max(rest, 0)]] += 1
    return n


def occupancy_shares(gen, num_pdfs: int, sigma: float, device) -> np.ndarray:
    """Occupancy shares of the pdfs: log-normal with ``sigma``, summing to 1,
    the same set for every seed (``traffic.fixed_set``)."""
    z = fixed_set(lambda g: torch.randn(num_pdfs, generator=g, device=device,
                                        dtype=torch.float64), gen, device)
    s = torch.exp(sigma * z)
    return (s / s.sum()).cpu().numpy()


def _slots(counts: np.ndarray) -> int:
    return 1 << (int(counts.max()) - 1).bit_length()


def draw_gmm(gen, device, counts: np.ndarray, mean: torch.Tensor, spread: torch.Tensor,
             var: torch.Tensor, var_lo: float, var_hi: float, weights: str) -> dict:
    """``counts [P]`` Gaussians per pdf around ``mean [P, D]``: means at
    ``mean + spread * N(0, 1)``, variances ``var * U(var_lo, var_hi)``;
    weights equal or Dirichlet(4)."""
    p, d = mean.shape
    m = _slots(counts)
    live = torch.arange(m, device=device)[None] < torch.as_tensor(counts, device=device)[:, None]
    means = mean[:, None] + spread * torch.randn((p, m, d), generator=gen, device=device,
                                                 dtype=torch.float64)
    varis = var * uniform(gen, (p, m, d), var_lo, var_hi, device)
    if weights == "equal":
        w = live.double()
    else:
        w = torch._standard_gamma(torch.full((p, m), 4.0, device=device, dtype=torch.float64),
                                  generator=gen) * live
    w = w / w.sum(dim=1, keepdim=True)
    means = torch.where(live[..., None], means, torch.zeros_like(means))
    varis = torch.where(live[..., None], varis, torch.ones_like(varis))
    return {"means": means.cpu().numpy(), "vars": varis.cpu().numpy(),
            "weights": w.cpu().numpy()}


def perturbed(gmm: dict, gen, device, mean_step: float, var_lo: float, var_hi: float) -> dict:
    """A start for EM: each live Gaussian's mean moved by ``mean_step``
    standard deviations along a normal draw, its variances scaled by
    ``U(var_lo, var_hi)``."""
    mean = torch.as_tensor(gmm["means"], device=device)
    var = torch.as_tensor(gmm["vars"], device=device)
    live = torch.as_tensor(gmm["weights"] > 0, device=device)[..., None]
    step = mean_step * var.sqrt() * torch.randn(mean.shape, generator=gen, device=device,
                                                dtype=torch.float64)
    scale = uniform(gen, var.shape, var_lo, var_hi, device)
    return {"means": torch.where(live, mean + step, mean).cpu().numpy(),
            "vars": torch.where(live, var * scale, var).cpu().numpy(),
            "weights": gmm["weights"].copy()}


def to_am(gmm: dict):
    """The program's ``AmDiagGmm`` of a GMM (float32 ``mean/var`` and
    ``1/var``)."""
    from voicebridge_tpu_torch.models.gmm import AmDiagGmm

    inv = 1.0 / gmm["vars"]
    return AmDiagGmm((gmm["means"] * inv).astype(np.float32), inv.astype(np.float32),
                     gmm["weights"].astype(np.float32))


def from_am(am) -> dict:
    """A GMM dict of the program's ``AmDiagGmm`` (float64)."""
    iv = am.inv_vars.astype(np.float64)
    return {"means": am.means_invvars.astype(np.float64) / iv, "vars": 1.0 / iv,
            "weights": am.weights.astype(np.float64)}


def decode_graph(gen, device, num_states: int, arcs_per_state: int, num_pdfs: int,
                 max_jump: int) -> dict:
    """An HCLG-shaped graph: every state has ``arcs_per_state`` arcs, the
    first a self-loop, the others to states 1..max_jump-1 ahead (cyclic);
    all arcs into a state carry its pdf; graph costs exponential(1); start
    in state 0, every state final with cost 0."""
    a = num_states * arcs_per_state
    src = torch.arange(num_states, device=device).repeat_interleave(arcs_per_state)
    jump = torch.randint(1, max_jump, (a,), generator=gen, device=device)
    jump[::arcs_per_state] = 0
    dst = (src + jump) % num_states
    state_pdf = torch.randint(0, num_pdfs, (num_states,), generator=gen, device=device)
    score = -torch.empty(a, device=device, dtype=torch.float64).exponential_(1.0, generator=gen)
    alpha0 = np.full(num_states, -math.inf)
    alpha0[0] = 0.0
    return {"src": src.cpu().numpy().astype(np.int32), "dst": dst.cpu().numpy().astype(np.int32),
            "pdf": state_pdf[dst].cpu().numpy().astype(np.int32),
            "score": score.float().cpu().numpy(), "alpha0": alpha0,
            "final": np.zeros(num_states)}


def to_dense_graph(g: dict):
    """The program's ``DenseGraph`` of a graph dict."""
    from voicebridge_tpu_torch.ops.graph import NEG_INF, DenseGraph

    def scores(v):
        return np.where(np.isfinite(v), v, NEG_INF).astype(np.float32)

    s = len(g["alpha0"])
    zeros_a = np.zeros(len(g["src"]), np.int32)
    return DenseGraph(num_states=s, arc_src=g["src"], arc_dst=g["dst"], arc_tid=g["pdf"],
                      arc_pdf=g["pdf"], arc_score=g["score"].astype(np.float32),
                      arc_oseq=zeros_a, alpha0=scores(g["alpha0"]),
                      start_oseq=np.zeros(s, np.int32),
                      final_score=scores(g["final"]),
                      final_oseq=np.zeros(s, np.int32), oseqs=[()])

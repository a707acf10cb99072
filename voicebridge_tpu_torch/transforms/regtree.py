"""Regression-tree fMLLR / MLLR adaptation.

Port of ``voicebridge_tpu/transforms/regtree.py``, the counterpart of the
reference's regression-tree transforms (``transform/regression-tree.{h,cc}``
``RegressionTree``, ``transform/regtree-fmllr-diag-gmm.{h,cc}``,
``transform/regtree-mllr-diag-gmm.{h,cc}``): Gaussians are clustered into
base classes by a binary tree over their means; per-speaker statistics are
accumulated per base class on the device, and at estimation time each leaf
walks up the tree to the lowest ancestor with enough occupancy, yielding one
affine transform per *regression class*.

The tree, the class choice and the row solves are numpy copies of the JAX
package's (over ``transforms/fmllr.estimate_fmllr_batch``).  On the device:

* ``acc_regtree_fmllr_stats``: per class, the 256-row fp32 block products
  with float64 sums of ``transforms/fmllr.py``, on the posteriors of the
  class's Gaussians (no ``[N, M, C]`` one-hot);
* ``regtree_fmllr_loglikes``: one launch of the GMM kernel (K2) per
  regression class, on the features transformed by that class with every
  Gaussian outside it inactive, combined by ``logsumexp_r(logdet_r +
  ll_r)``; ``regtree_fmllr_loglikes_plain`` is the JAX formulation;
* ``acc_regtree_mllr_stats``: the occupancies and first moments of the
  E-step kernel (K6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import ieee_fp32_entry, resolve_device
from ..ops import gmm_kernel
from ..ops.gmm_kernels import (GmmParams, acc_gmm_stats_chunked, aligned_mixture_logliks,
                               component_logliks)
from .fmllr import SUB_FRAMES, _fmllr_blocks, estimate_fmllr_batch, fmllr_chunk_rows

NEG = gmm_kernel.NEG  # an inactive Gaussian's gconst in K2's weights


# ---------------------------------------------------------------------------
# Regression tree (host; built once per model)
# ---------------------------------------------------------------------------


@dataclass
class RegressionTree:
    """Binary tree over Gaussians. Leaves are base classes ``0..C-1``;
    ``parent[n]`` gives each node's parent (root's is -1). ``bclass_of``
    maps (pdf, mix) -> leaf id (-1 for padded/inactive components)."""

    bclass_of: np.ndarray      # [P, M] int32
    parent: np.ndarray         # [num_nodes] int32
    num_leaves: int

    @property
    def num_nodes(self) -> int:
        return len(self.parent)


def _two_means(x: np.ndarray, w: np.ndarray, iters: int = 10, seed: int = 0):
    """Weighted 2-means split; returns bool mask for cluster 1."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    c0 = x[int(rng.integers(n))]
    far = np.argmax(((x - c0) ** 2).sum(1))
    c1 = x[int(far)]
    assign = np.zeros(n, bool)
    for _ in range(iters):
        d0 = ((x - c0) ** 2).sum(1)
        d1 = ((x - c1) ** 2).sum(1)
        new = d1 < d0
        if (new == assign).all():
            break
        assign = new
        for side, mask in ((0, ~assign), (1, assign)):
            if mask.any():
                c = (w[mask, None] * x[mask]).sum(0) / w[mask].sum()
                if side == 0:
                    c0 = c
                else:
                    c1 = c
    if not assign.any() or assign.all():  # degenerate: split by median dim
        dim = np.argmax(x.var(0))
        assign = x[:, dim] > np.median(x[:, dim])
    return assign


def build_regression_tree(means: np.ndarray, weights: np.ndarray,
                          num_baseclasses: int, active: np.ndarray | None = None,
                          seed: int = 0) -> RegressionTree:
    """Top-down binary splitting of Gaussian means into ``num_baseclasses``
    leaves (``RegressionTree::BuildTree`` role: largest-occupancy node is
    split first).

    means [P, M, D], weights [P, M] (occupancy or mixture weights);
    ``active`` marks real (non-padded) components.
    """
    p, m, d = means.shape
    flat_mu = means.reshape(p * m, d).astype(np.float64)
    flat_w = weights.reshape(p * m).astype(np.float64)
    if active is None:
        active = flat_w > 0
    else:
        active = active.reshape(p * m).astype(bool)
    idx_active = np.nonzero(active)[0]
    num_baseclasses = max(1, min(num_baseclasses, len(idx_active)))

    # leaves as index lists; split the heaviest splittable leaf repeatedly
    leaves = [idx_active]
    while len(leaves) < num_baseclasses:
        order = np.argsort([-flat_w[leaf].sum() for leaf in leaves])
        split_at = next((i for i in order if len(leaves[int(i)]) > 1), None)
        if split_at is None:
            break
        leaf = leaves.pop(int(split_at))
        mask = _two_means(flat_mu[leaf], np.maximum(flat_w[leaf], 1e-8),
                          seed=seed + len(leaves))
        leaves.insert(int(split_at), leaf[~mask])
        leaves.append(leaf[mask])

    c = len(leaves)
    bclass = np.full(p * m, -1, np.int32)
    for li, leaf in enumerate(leaves):
        bclass[leaf] = li
    # build a balanced binary merge hierarchy over the leaves by re-merging
    # nearest centroids (parents get ids c, c+1, ...)
    cents = [((flat_w[leaf, None] * flat_mu[leaf]).sum(0) /
              max(flat_w[leaf].sum(), 1e-8)) for leaf in leaves]
    occs = [flat_w[leaf].sum() for leaf in leaves]
    nodes = list(range(c))
    parent = [-1] * c
    cur = {i: (cents[i], occs[i]) for i in range(c)}
    next_id = c
    while len(nodes) > 1:
        best = None
        for i in range(len(nodes)):
            for j in range(i + 1, len(nodes)):
                dist = float(((cur[nodes[i]][0] - cur[nodes[j]][0]) ** 2).sum())
                if best is None or dist < best[0]:
                    best = (dist, i, j)
        _, i, j = best
        a, b = nodes[i], nodes[j]
        parent.append(-1)
        parent[a] = next_id
        parent[b] = next_id
        wa, wb = cur[a][1], cur[b][1]
        cur[next_id] = ((cur[a][0] * wa + cur[b][0] * wb) / max(wa + wb, 1e-8),
                        wa + wb)
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [next_id]
        next_id += 1
    return RegressionTree(bclass.reshape(p, m), np.asarray(parent, np.int32), c)


# ---------------------------------------------------------------------------
# Per-baseclass fMLLR statistics (device)
# ---------------------------------------------------------------------------


@ieee_fp32_entry
def acc_regtree_fmllr_stats(params: GmmParams, means, inv_vars, feats, pdf_ids, weights,
                            bclass_of, num_classes: int, chunk: int | None = None, *,
                            device=None):
    """One speaker's per-baseclass statistics
    (``RegtreeFmllrDiagGmmAccs::AccumulateForGmm`` role).

    feats [N, D] aligned to pdf_ids [N] with frame weights [N]; bclass_of
    [P, M] -> (beta [C], K [C, D, D+1], G [C, D, D+1, D+1]), float32 tensors
    on ``device`` (``None``: the card).  Per class c, the posteriors of the
    Gaussians in c collapse each row to (mass, w_miv, w_iv), and K and G are
    the float64 block products of ``transforms/fmllr.py`` over blocks of
    ``SUB_FRAMES`` rows.  Rows of weight 0 add nothing and
    are left out; ``chunk`` rows (whole blocks) at a time, by default what
    the device's free memory holds."""
    dev = resolve_device(device)
    params = params.to(dev)
    means = torch.as_tensor(means, dtype=torch.float32).to(dev)
    inv_vars = torch.as_tensor(inv_vars, dtype=torch.float32).to(dev)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    pdf_ids = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    bclass = torch.as_tensor(np.asarray(bclass_of)).to(dev, torch.int64)
    d = feats.shape[1]
    e = d + 1
    rows = torch.nonzero(weights != 0).squeeze(1)
    n = rows.shape[0]
    padded = -(-n // SUB_FRAMES) * SUB_FRAMES
    c = max(1, (chunk or fmllr_chunk_rows(dev, means.shape[1], d)) // SUB_FRAMES) * SUB_FRAMES
    beta = torch.zeros(num_classes, dtype=torch.float64, device=dev)
    k = torch.zeros((num_classes, d, e), dtype=torch.float64, device=dev)
    g = torch.zeros((num_classes, d * e, e), dtype=torch.float64, device=dev)
    for lo in range(0, padded, c):
        hi = min(lo + c, padded)
        r = rows[lo:hi]
        pad = (hi - lo) - r.shape[0]  # the last block's padding rows: weight 0
        x = torch.cat([feats[r], feats.new_zeros((pad, d))])
        pdf = torch.cat([pdf_ids[r], pdf_ids.new_zeros(pad)])
        w = torch.cat([weights[r], weights.new_zeros(pad)])
        gamma = torch.softmax(aligned_mixture_logliks(params, x, pdf), dim=1) * w[:, None]
        mu_iv, iv = means[pdf] * inv_vars[pdf], inv_vars[pdf]  # [n, M, D]
        cls = bclass[pdf]  # [n, M]
        for q in range(num_classes):
            gq = torch.where(cls == q, gamma, 0.0)
            b_blk, k_blk, g_blk = _fmllr_blocks(
                gq.sum(dim=1), torch.einsum("nm,nmd->nd", gq, mu_iv),
                torch.einsum("nm,nmd->nd", gq, iv), x)
            beta[q] += b_blk.sum()
            k[q] += k_blk.sum(dim=0)
            g[q] += g_blk.sum(dim=0)
    return beta.float(), k.float(), g.view(num_classes, d, e, e).float()


# ---------------------------------------------------------------------------
# Estimation with tree fallback (host)
# ---------------------------------------------------------------------------


def choose_regression_classes(tree: RegressionTree, leaf_occ: np.ndarray,
                              min_count: float) -> tuple[np.ndarray, list]:
    """Walk each leaf up to its lowest ancestor with occupancy >= min_count
    (``RegressionTree::GatherStats`` role). Returns (leaf -> class index,
    list of chosen tree nodes, one per class)."""
    occ = np.zeros(tree.num_nodes)
    occ[: tree.num_leaves] = leaf_occ
    # push occupancies up the tree (parents have larger ids)
    for node in range(tree.num_nodes):
        par = tree.parent[node]
        if par >= 0:
            occ[par] += occ[node]
    chosen: dict[int, int] = {}
    leaf_to_class = np.zeros(tree.num_leaves, np.int32)
    nodes: list[int] = []
    for leaf in range(tree.num_leaves):
        node = leaf
        while occ[node] < min_count and tree.parent[node] >= 0:
            node = int(tree.parent[node])
        if node not in chosen:
            chosen[node] = len(nodes)
            nodes.append(node)
        leaf_to_class[leaf] = chosen[node]
    return leaf_to_class, nodes


def _pool_by_class(tree: RegressionTree, leaf_to_class: np.ndarray,
                   num_classes: int, *stats):
    """Sum per-leaf stat arrays into per-class arrays."""
    out = []
    for s in stats:
        pooled = np.zeros((num_classes,) + s.shape[1:], np.float64)
        np.add.at(pooled, leaf_to_class, np.asarray(s, np.float64))
        out.append(pooled)
    return out


def estimate_regtree_fmllr(tree: RegressionTree, beta: np.ndarray,
                           k: np.ndarray, g: np.ndarray,
                           min_count: float = 1000.0, num_iters: int = 20):
    """Per-leaf stats -> (transforms [R, D, D+1], leaf_to_class [C],
    objf impr/frame list) (``RegtreeFmllrDiagGmmAccs::Update``)."""
    leaf_to_class, nodes = choose_regression_classes(tree, beta, min_count)
    r = len(nodes)
    pb, pk, pg = _pool_by_class(tree, leaf_to_class, r, beta[:, None], k, g)
    pb = pb[:, 0]
    # below-min-count classes (possible only at the root) keep identity
    w, imprs = estimate_fmllr_batch(pb, pk, pg, min_count=min(min_count, 1.0),
                                    num_iters=num_iters)
    return w, leaf_to_class, imprs


def class_of_gaussians(bclass_of, leaf_to_class) -> np.ndarray:
    """``[P, M]`` regression class of each Gaussian, -1 where inactive."""
    bc = np.asarray(bclass_of)
    return np.where(bc >= 0, np.asarray(leaf_to_class)[np.maximum(bc, 0)], -1)


def class_weights(params: GmmParams, cls: np.ndarray, r: int):
    """The model with every Gaussian outside class ``r`` (``cls [P, M]``, the
    host's class map) inactive (gconst ``NEG``, not live), and ``[P]`` (host)
    whether a pdf keeps any Gaussian."""
    in_r = cls == r
    w_r = params.w.clone()
    w_r[..., -1] = torch.where(torch.from_numpy(in_r).to(w_r.device), w_r[..., -1], NEG)
    return GmmParams(w_r, params.live & in_r), in_r.any(axis=1)


@ieee_fp32_entry
def regtree_fmllr_loglikes(params: GmmParams, feats, transforms, leaf_to_class,
                           bclass_of) -> torch.Tensor:
    """Adapted per-frame per-pdf log-likelihoods
    (``RegtreeFmllrDiagGmm::LogLikelihood`` role): each Gaussian is scored on
    the feature transformed by its regression class, plus log|det A_c|.

    feats [N, D] -> [N, P] loglikes on the parameters' device.  One K2 launch
    (``ops/gmm_kernel.loglikes``; its plain version on the CPU) per class r,
    on ``A_r x + b_r`` with every Gaussian outside r inactive (gconst
    ``NEG``); the classes combine by ``logsumexp_r(logdet_r + ll_r)``, which
    equals the single logsumexp over Gaussians up to rounding.  A pdf with
    no Gaussian in r takes no part in r's term, so a pdf with no active
    Gaussian at all comes out ``-inf``."""
    dev = params.w.device
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    trans = torch.as_tensor(np.asarray(transforms), dtype=torch.float32).to(dev)
    logdets = torch.linalg.slogdet(trans[:, :, :-1].double())[1].float()
    cls = class_of_gaussians(bclass_of, leaf_to_class)
    out = None
    for r in range(trans.shape[0]):
        gmm_r, active = class_weights(params, cls, r)
        if not active.any():
            continue
        x_r = torch.addmm(trans[r, :, -1], feats, trans[r, :, :-1].T)
        ll = gmm_kernel.loglikes(x_r.contiguous(), gmm_r) + logdets[r]
        ll = torch.where(torch.from_numpy(active).to(dev)[None, :], ll, -torch.inf)
        out = ll if out is None else torch.logaddexp(out, ll)
    if out is None:
        out = feats.new_full((feats.shape[0], params.num_pdfs), -torch.inf)
    return out


@ieee_fp32_entry
def regtree_fmllr_loglikes_plain(params: GmmParams, feats: torch.Tensor, transforms,
                                 leaf_to_class, bclass_of) -> torch.Tensor:
    """The JAX formulation in torch, in the features' dtype: every Gaussian
    scored on every class's transform (``[N, R, P, M]``), its own class's
    score taken, plus that class's log|det A|, inactive Gaussians ``-inf``,
    one logsumexp over the pdf's Gaussians."""
    dt, dev = feats.dtype, feats.device
    params = params.to(dev, dt)
    w = torch.as_tensor(np.asarray(transforms)).to(dev, dt)
    a, b = w[:, :, :-1], w[:, :, -1]
    xr = torch.einsum("rde,ne->nrd", a, feats) + b[None]  # [N, R, D]
    logdets = torch.linalg.slogdet(a)[1]
    comp = torch.stack([component_logliks(params, xr[:, r]) for r in range(w.shape[0])],
                       dim=1)  # [N, R, P, M]
    bc = torch.as_tensor(np.asarray(bclass_of)).to(dev)
    cls = torch.as_tensor(class_of_gaussians(bclass_of, leaf_to_class)).to(dev)
    cls_safe = cls.clamp(min=0)
    idx = cls_safe[None, None].expand(comp.shape[0], 1, *cls.shape)
    sel = torch.gather(comp, 1, idx)[:, 0] + logdets[cls_safe][None]  # [N, P, M]
    sel = torch.where((bc >= 0)[None], sel, -torch.inf)
    return torch.logsumexp(sel, dim=2)


# ---------------------------------------------------------------------------
# Regression-tree MLLR (mean adaptation; RegtreeMllrDiagGmm)
# ---------------------------------------------------------------------------


@ieee_fp32_entry
def acc_regtree_mllr_stats(params: GmmParams, feats, pdf_ids, weights):
    """Per-Gaussian occupancies and first moments for MLLR
    (``RegtreeMllrDiagGmmAccs`` role): (occ [P, M], xbar [P, M, D]) numpy
    float32, the occupancies and mean accumulators of the E-step kernel (K6,
    ``ops/gmm_kernels.acc_gmm_stats_chunked``) on the parameters' device."""
    occ, xbar, _var, _ll = acc_gmm_stats_chunked(params, feats, pdf_ids, params.num_pdfs,
                                                 weights)
    return occ, xbar


def estimate_regtree_mllr(tree: RegressionTree, occ: np.ndarray,
                          xbar: np.ndarray, means: np.ndarray,
                          inv_vars: np.ndarray, min_count: float = 1000.0):
    """Closed-form per-class mean transforms mu' = A mu + b
    (``RegtreeMllrDiagGmmAccs::Update``): per row d,
    G_d = sum_g occ_g ivar_gd muhat muhat^T, k_d = sum_g ivar_gd xbar_gd muhat.

    Returns (transforms [R, D, D+1], leaf_to_class)."""
    p, m, d = means.shape
    flat = lambda x: np.asarray(x, np.float64).reshape(p * m, *x.shape[2:])
    occ_f, xbar_f = flat(occ), flat(xbar)
    mu_f, iv_f = flat(means), flat(inv_vars)
    bc = tree.bclass_of.reshape(p * m)
    leaf_occ = np.zeros(tree.num_leaves)
    valid = bc >= 0
    np.add.at(leaf_occ, bc[valid], occ_f[valid])
    leaf_to_class, nodes = choose_regression_classes(tree, leaf_occ, min_count)
    r = len(nodes)
    muhat = np.concatenate([mu_f, np.ones((p * m, 1))], axis=1)      # [G, D+1]
    gcls = np.where(valid, leaf_to_class[np.maximum(bc, 0)], 0)
    w_occ = np.where(valid, occ_f, 0.0)
    # per-class per-row normal equations
    gmat = np.zeros((r, d, d + 1, d + 1))
    kmat = np.zeros((r, d, d + 1))
    outer = muhat[:, :, None] * muhat[:, None, :]                    # [G, D+1, D+1]
    for c in range(r):
        sel = gcls == c
        if not sel.any():
            continue
        wiv = (w_occ[sel, None] * iv_f[sel])                         # [g, D]
        gmat[c] = np.einsum("gd,gef->def", wiv, outer[sel])
        kmat[c] = np.einsum("gd,gd,ge->de", iv_f[sel], xbar_f[sel], muhat[sel])
    xforms = np.broadcast_to(
        np.concatenate([np.eye(d), np.zeros((d, 1))], 1), (r, d, d + 1)).copy()
    for c in range(r):
        cnt = sum(leaf_occ[le] for le in range(tree.num_leaves)
                  if leaf_to_class[le] == c)
        if cnt < 1.0:
            continue
        for i in range(d):
            tr = np.trace(gmat[c, i]) / (d + 1)
            reg = 1e-6 * max(tr, 1e-10) * np.eye(d + 1)
            xforms[c, i] = np.linalg.solve(gmat[c, i] + reg, kmat[c, i])
    return xforms.astype(np.float32), leaf_to_class


def apply_regtree_mllr(means: np.ndarray, tree: RegressionTree,
                       transforms: np.ndarray, leaf_to_class: np.ndarray
                       ) -> np.ndarray:
    """Adapted means mu' = A_c mu + b_c per Gaussian ([P, M, D] -> same)."""
    p, m, d = means.shape
    bc = tree.bclass_of.reshape(p * m)
    mu = means.reshape(p * m, d)
    cls = np.where(bc >= 0, leaf_to_class[np.maximum(bc, 0)], 0)
    w = transforms[cls]                                              # [G, D, D+1]
    out = np.einsum("gde,ge->gd", w[:, :, :d], mu) + w[:, :, d]
    out = np.where((bc >= 0)[:, None], out, mu)
    return out.reshape(p, m, d).astype(means.dtype)

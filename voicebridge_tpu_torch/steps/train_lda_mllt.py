"""LDA+MLLT triphone training.

Port of ``voicebridge_tpu/steps/train_lda_mllt.py`` (the reference's
``TrainLdaMllt``): from the previous system's alignments, estimate an LDA
projection over spliced features (AliToPost -> WeightSilencePost -> AccLda
-> EstLda), build a new tree on the projected features, then run EM
re-estimating a global MLLT/STC transform on iterations ``mllt_iters``
(GmmAccMllt -> EstMllt -> GmmTransformMeans -> ComposeTransforms),
realigning on ``realign_iters``.

Features: ``base_feats`` = CMVN'd MFCCs (13-dim; ``make_features(...,
deltas=None)``).  The step splices them (+-3) and projects them (LDA to 40)
on the device, as tensors, for the whole run; it returns the composed
``final_mat`` (the reference's final.mat) used at decode time
(``lda_decode_feats``).  Each iteration's pieces are functions of their own
(``estimate_lda_from_alignment``, ``mllt_update``, and ``train_tri``'s
``e_step`` and ``m_step``), which ``chip_smoke.py`` also calls at full width.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import LdaOptions, SpliceOptions, TriTrainOptions
from ..data.lang import Lang
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.treebuild import acc_tree_stats, build_tree
from ..utils.logging import get_logger

from ..device import ieee_fp32_entry, resolve_device
from ..ops import gmm_kernels as K
from ..ops.features import splice_frames_batch
from ..transforms.lda import acc_lda_stats, apply_affine_transform, estimate_lda
from ..transforms.mllt import (acc_mllt_stats, compose_transforms, est_mllt,
                               transform_model_means)
from .train_mono import TrainedModel, _batchify, save_model
from .train_tri import (converted_alignments, e_step, host_feats,
                        init_model_from_tree_stats, m_step, realign, silence_pdfs_of,
                        training_graphs)

log = get_logger()


def silence_frame_weights(tids, weights, trans_model, silence_phones: set,
                          silence_weight: float):
    """weight-silence-post: scale frames aligned to silence phones."""
    phones = trans_model.tid2phone[tids]
    sil = np.isin(phones, list(silence_phones))
    return np.where(sil & (weights > 0), silence_weight * weights, weights)


@ieee_fp32_entry
def estimate_lda_from_alignment(spliced: torch.Tensor, pdf_ids: np.ndarray,
                                weights: np.ndarray, num_pdfs: int,
                                lda_opts: LdaOptions = LdaOptions(), mesh=None) -> np.ndarray:
    """acc-lda + est-lda: statistics of the spliced frames ``[N, D]`` per
    aligned pdf on the device (or sharded over ``mesh``), the projection on
    the host -> the affine LDA matrix ``[lda_opts.dim, D + 1]``."""
    counts, mean_acc, scatter = acc_lda_stats(spliced, pdf_ids, weights, num_pdfs, mesh=mesh)
    return estimate_lda(counts.cpu().numpy(), mean_acc.cpu().numpy(),
                        scatter.cpu().numpy(), lda_opts.dim, lda_opts.within_class_factor)


@ieee_fp32_entry
def mllt_update(am: AmDiagGmm, feats: torch.Tensor, spliced: torch.Tensor,
                cur_mat: np.ndarray, pdf_ids: np.ndarray, weights: np.ndarray, mesh=None):
    """One MLLT update: statistics of the projected features ``feats [B, T,
    E]`` under the aligned pdfs ``pdf_ids [B*T]`` with frame weights
    ``weights [B*T]`` on the device (or sharded over ``mesh``) -> ``est_mllt`` ->
    ``transform_model_means`` (``am`` in place) -> ``compose_transforms`` ->
    the spliced features ``[B, T, D]`` re-projected on the device.  Returns
    (new final matrix, new features, objf improvement per frame)."""
    b, t, dim = feats.shape
    g, beta = acc_mllt_stats(K.pack_gmm(am, feats.device), am.means(), am.inv_vars,
                             feats.reshape(b * t, dim), pdf_ids, weights, mesh=mesh)
    m, impr = est_mllt(g.cpu().numpy(), beta)
    transform_model_means(am, m)
    cur_mat = compose_transforms(m, cur_mat)
    return cur_mat, apply_affine_transform(spliced, cur_mat), impr


@ieee_fp32_entry
def train_lda_mllt(base_feats: dict, transcripts: dict, prev_alignments: dict,
                   lang: Lang, opts: TriTrainOptions = TriTrainOptions(),
                   lda_opts: LdaOptions = LdaOptions(),
                   splice_opts: SpliceOptions = SpliceOptions(),
                   prev_trans_model: TransitionModel | None = None,
                   out_dir: str | Path | None = None, mesh=None, *, device=None):
    """Returns (TrainedModel, final_mat [40, spliced_dim+1]).  ``mesh``
    (``parallel/mesh.make_mesh``) routes the LDA, MLLT and tree statistics
    through the data-axis-sharded reductions."""
    if prev_trans_model is None:
        raise ValueError("prev_trans_model: the model of prev_alignments is needed")
    device = resolve_device(device)
    utts = sorted(base_feats)
    raw, num_frames = _batchify([base_feats[u] for u in utts], device)
    b, t_max, _ = raw.shape
    spliced = splice_frames_batch(raw, torch.from_numpy(num_frames), splice_opts)
    sdim = spliced.shape[2]

    # previous alignments -> frame weights (silence down-weighted for LDA)
    tids0 = np.zeros((b, t_max), np.int32)
    w0 = np.zeros((b, t_max), np.float32)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            tids0[i, : len(a)] = a
            w0[i, : len(a)] = 1.0
    sil_set = set(lang.silence_phone_ids)
    w_lda = silence_frame_weights(tids0.reshape(-1), w0.reshape(-1), prev_trans_model,
                                  sil_set, opts.silence_weight)

    # ---- LDA estimation ----------------------------------------------------
    cur_mat = estimate_lda_from_alignment(
        spliced.reshape(b * t_max, sdim), prev_trans_model.tid2pdf[tids0.reshape(-1)],
        w_lda, prev_trans_model.num_pdfs, lda_opts, mesh)  # final.mat so far: [40, sdim+1]
    feats = apply_affine_transform(spliced, cur_mat)
    dim = feats.shape[2]
    log.info("train_lda_mllt: LDA %d -> %d estimated", sdim, dim)

    # ---- tree on LDA features ---------------------------------------------
    ali_by_utt = {u: list(tids0[i, : num_frames[i]])
                  for i, u in enumerate(utts) if w0[i].sum() > 0}
    tree_stats = acc_tree_stats(ali_by_utt, dict(zip(utts, host_feats(feats, num_frames))),
                                prev_trans_model, opts.context_width,
                                opts.central_position, ci_phones=sil_set, mesh=mesh)
    tree = build_tree(tree_stats, lang, opts.context_width, opts.central_position,
                      num_leaves=opts.num_leaves)
    trans_model = TransitionModel(lang.topo, tree)
    am = init_model_from_tree_stats(tree, tree_stats, min_variance=opts.min_variance)
    log.info("train_lda_mllt: tree has %d leaves; %d tids", tree.num_pdfs,
             trans_model.num_transition_ids)

    tids, weights = converted_alignments(utts, prev_alignments, prev_trans_model,
                                         trans_model, t_max, opts)
    aset = training_graphs(lang, tree, trans_model, transcripts, utts, opts, device,
                           "train_lda_mllt")
    silence_pdfs = silence_pdfs_of(lang, tree)

    num_gauss = am.num_gauss
    inc_gauss = max((opts.totgauss - num_gauss) // opts.max_iter_inc, 0)
    for it in range(1, opts.num_iters + 1):
        if it in opts.realign_iters:
            realign(aset, am, feats, num_frames, tids, weights, silence_pdfs, opts,
                    "train_lda_mllt realign", utts)
        if it in opts.mllt_iters:
            w_m = silence_frame_weights(tids.reshape(-1), weights.reshape(-1), trans_model,
                                        sil_set, opts.silence_weight)
            cur_mat, feats, impr = mllt_update(am, feats, spliced, cur_mat,
                                               trans_model.tid2pdf[tids.reshape(-1)], w_m,
                                               mesh)
            log.info("train_lda_mllt iter %d: MLLT impr/frame %.5f", it, impr)
        stats = e_step(am, trans_model, feats.reshape(b * t_max, dim), tids, weights)
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        m_step(am, trans_model, stats, num_gauss, opts, seed=2000 + it)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_lda_mllt iter %d: loglike/frame %.4f, num_gauss %d",
                     it, float(stats[4]) / max(float(weights.sum()), 1.0), am.num_gauss)

    model = TrainedModel(am, trans_model, tree, lang, aset.aligner)
    if out_dir:
        out = Path(out_dir)
        save_model(out, am, trans_model, tree)
        np.save(out / "final.mat.npy", cur_mat)
    return model, cur_mat


@ieee_fp32_entry
def lda_decode_feats(base_feats: dict, final_mat: np.ndarray,
                     splice_opts: SpliceOptions = SpliceOptions(), *,
                     device=None) -> dict:
    """Apply the splice+LDA(+MLLT) chain for decoding (decode_gmm.cpp:519-550)
    on ``device``: utt -> [T, E] tensor there."""
    device = resolve_device(device)
    utts = sorted(base_feats)
    feats, nf = _batchify([base_feats[u] for u in utts], device)
    out = apply_affine_transform(splice_frames_batch(feats, torch.from_numpy(nf), splice_opts),
                                 final_mat)
    return {u: out[i, : nf[i]] for i, u in enumerate(utts)}

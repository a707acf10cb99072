"""Speaker-adapted training (SAT) with per-speaker fMLLR.

Port of ``voicebridge_tpu/steps/train_sat.py`` (the reference's
``TrainSat``): initial per-speaker fMLLR from the previous system's
alignments, tree rebuild on adapted features, EM with transforms
re-estimated on ``fmllr_iters``, and a final speaker-independent ``alimdl``
(GmmAccStatsTwofeats) for the first pass of ``decode_fmllr``.

Features stay on ``device`` for the whole run; the tree statistics take the
adapted features to the host once.  All speakers' fMLLR statistics are one
device pass (``transforms/fmllr.acc_fmllr_stats``), the row solves run on
the host for all speakers at once; transforms are re-estimated from the
*base* features with the current model each time, as the JAX package does.
Realignment runs K2 and K4 (or the generic aligner's kernels), the E-step K6,
and ``alimdl`` K6's two-feature path (posteriors from the adapted features,
statistics over the base features).  The tree, the M-step and mixup are
host numpy, in the JAX package's order and with its seeds.  Each piece is a
function of its own (``estimate_transforms``, ``train_tri``'s ``realign``,
``e_step`` and ``m_step``, ``alignment_model``), which ``chip_smoke.py``
also calls at full width.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..config import TriTrainOptions
from ..data.lang import Lang
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.treebuild import acc_tree_stats, build_tree
from ..utils.logging import get_logger

from ..device import ieee_fp32_entry, resolve_device
from ..ops import gmm_kernels as K
from ..transforms.fmllr import acc_fmllr_stats, apply_fmllr_batch, estimate_fmllr_batch
from .train_lda_mllt import silence_frame_weights
from .train_mono import TrainedModel, _batchify, save_model
from .train_tri import (e_step, host_feats, init_model_from_tree_stats, m_step, realign,
                        silence_pdfs_of, training_graphs)

log = get_logger()


@dataclass
class SatModel:
    model: TrainedModel
    alimdl: AmDiagGmm  # speaker-independent model for first-pass decoding
    transforms: dict  # speaker -> [D, D+1] (training speakers)


@ieee_fp32_entry
def estimate_transforms(am: AmDiagGmm, base_flat: torch.Tensor, pdf_ids, weights, spk_ids,
                        num_speakers: int, min_count: float = 500.0, mesh=None):
    """fMLLR statistics of the base features ``[N, D]`` under the aligned
    pdfs on their device (or sharded over ``mesh``), then the row solves on
    the host -> (transforms ``[S, D, D+1]``, objective improvement per frame
    of each speaker)."""
    dev = base_flat.device
    beta, k, g = acc_fmllr_stats(K.pack_gmm(am, dev), am.means(), am.inv_vars, base_flat,
                                 pdf_ids, weights, spk_ids, num_speakers, mesh=mesh,
                                 device=dev)
    return estimate_fmllr_batch(beta.cpu().numpy(), k.cpu().numpy(), g.cpu().numpy(),
                                min_count=min_count)


@ieee_fp32_entry
def alignment_model(am: AmDiagGmm, x_adapted: torch.Tensor, base_flat: torch.Tensor,
                    pdf_ids, weights, num_pdfs: int, opts: TriTrainOptions) -> AmDiagGmm:
    """gmm-acc-stats-twofeats + gmm-est: posteriors of ``am`` on the adapted
    features, statistics over the base features (K6's two-feature path) ->
    the speaker-independent ``alimdl``."""
    occ, macc, vacc, _ll = K.acc_gmm_stats_twofeats_chunked(
        K.pack_gmm(am, x_adapted.device), x_adapted, base_flat, pdf_ids, num_pdfs, weights)
    alimdl = AmDiagGmm(am.means_invvars.copy(), am.inv_vars.copy(), am.weights.copy())
    alimdl.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, opts.min_variance)
    return alimdl


@ieee_fp32_entry
def train_sat(base_feats: dict, utt2spk: dict, transcripts: dict, prev_alignments: dict,
              prev_am: AmDiagGmm, lang: Lang, opts: TriTrainOptions = TriTrainOptions(),
              prev_trans_model: TransitionModel | None = None,
              out_dir: str | Path | None = None, mesh=None, *, device=None) -> SatModel:
    """``base_feats``: utt -> [T, D] features the transforms act on (delta
    or LDA+MLLT features; tensors or arrays); ``prev_alignments``: utt ->
    tids of ``prev_am`` / ``prev_trans_model``.  Writes ``save_model``'s
    files and ``final.alimdl.npz`` into ``out_dir``.  ``mesh``
    (``parallel/mesh.make_mesh``) routes the fMLLR and tree statistics
    through the data-axis-sharded reductions."""
    if prev_trans_model is None:
        raise ValueError("prev_trans_model: the model of prev_alignments is needed")
    device = resolve_device(device)
    utts = sorted(base_feats)
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    num_spk = len(speakers)
    raw, num_frames = _batchify([base_feats[u] for u in utts], device)
    b, t_max, dim = raw.shape
    spk_of_utt = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
    spk_flat = np.repeat(spk_of_utt, t_max)
    sil_set = set(lang.silence_phone_ids)
    base_flat = raw.reshape(b * t_max, dim)

    tids = np.zeros((b, t_max), np.int32)
    weights = np.zeros((b, t_max), np.float32)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            tids[i, : len(a)] = a
            weights[i, : len(a)] = 1.0

    def transforms(am, tm):
        w = silence_frame_weights(tids.reshape(-1), weights.reshape(-1), tm, sil_set,
                                  opts.silence_weight)
        trans, imprs = estimate_transforms(am, base_flat, tm.tid2pdf[tids.reshape(-1)], w,
                                           spk_flat, num_spk, mesh=mesh)
        mean_impr = float(np.mean([i for i in imprs if i] or [0.0]))  # over estimated speakers
        return trans, mean_impr, apply_fmllr_batch(raw, trans, spk_of_utt, device=device)

    # ---- initial transforms from the previous model ------------------------
    trans, impr, feats = transforms(prev_am, prev_trans_model)
    log.info("train_sat: initial fMLLR impr/frame %.4f (%d speakers)", impr, num_spk)

    # ---- tree on adapted features -----------------------------------------
    ali_by_utt = {u: list(tids[i, : num_frames[i]])
                  for i, u in enumerate(utts) if weights[i].sum() > 0}
    tree_stats = acc_tree_stats(ali_by_utt, dict(zip(utts, host_feats(feats, num_frames))),
                                prev_trans_model, opts.context_width, opts.central_position,
                                ci_phones=sil_set, mesh=mesh)
    tree = build_tree(tree_stats, lang, opts.context_width, opts.central_position,
                      num_leaves=opts.num_leaves)
    trans_model = TransitionModel(lang.topo, tree)
    am = init_model_from_tree_stats(tree, tree_stats, min_variance=opts.min_variance)
    log.info("train_sat: tree has %d leaves; %d tids", tree.num_pdfs,
             trans_model.num_transition_ids)

    new_tids = np.zeros_like(tids)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            conv = prev_trans_model.convert_alignment(
                a, trans_model, opts.context_width, opts.central_position)
            new_tids[i, : len(conv)] = conv
    tids = new_tids

    aset = training_graphs(lang, tree, trans_model, transcripts, utts, opts, device,
                           "train_sat")
    silence_pdfs = silence_pdfs_of(lang, tree)
    num_gauss = am.num_gauss
    inc_gauss = max((opts.totgauss - num_gauss) // opts.max_iter_inc, 0)
    for it in range(1, opts.num_iters + 1):
        if it in opts.fmllr_iters:
            trans, impr, feats = transforms(am, trans_model)
            log.info("train_sat iter %d: fMLLR impr/frame %.4f", it, impr)
        if it in opts.realign_iters:
            realign(aset, am, feats, num_frames, tids, weights, silence_pdfs, opts,
                    "train_sat realign", utts)
        stats = e_step(am, trans_model, feats.reshape(b * t_max, dim), tids, weights)
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        m_step(am, trans_model, stats, num_gauss, opts, seed=3000 + it)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_sat iter %d: loglike/frame %.4f, num_gauss %d",
                     it, stats[4] / max(float(weights.sum()), 1.0), am.num_gauss)

    # ---- speaker-independent alignment model (gmm-acc-stats-twofeats) ------
    alimdl = alignment_model(am, feats.reshape(b * t_max, dim), base_flat,
                             trans_model.tid2pdf[tids.reshape(-1)], weights.reshape(-1),
                             tree.num_pdfs, opts)
    model = TrainedModel(am, trans_model, tree, lang, aset.aligner)
    if out_dir:
        out = Path(out_dir)
        save_model(out, am, trans_model, tree)
        alimdl.save(out / "final.alimdl.npz")
    return SatModel(model=model, alimdl=alimdl,
                    transforms={s: trans[spk_idx[s]] for s in speakers})

"""Triphone GMM training with decision-tree state tying ("train_deltas").

Port of ``voicebridge_tpu/steps/train_tri.py`` (the reference's
``TrainDeltas``): tree prologue (AccTreeStats -> ClusterPhones ->
CompileQuestions -> BuildTree), GmmInitModel from tree stats, ConvertAli of
the previous stage's alignments, then the usual EM loop with Viterbi
realignment.  ``train_lda_mllt`` reuses this skeleton.

Features stay on ``device`` for the whole run; the tree statistics take
them to the host once, as float32 arrays.  Realignment runs K2 and K4 (or
the generic aligner's kernels where ``build_band_plan`` refuses the
triphone graphs; which one goes to the log) through
``AlignmentSet.align_feats_to_tids``, which writes the frames' transition
ids on the device and scatters them into ``tids``/``weights``; the E-step runs K6 through
``acc_gmm_stats_chunked`` and the transition statistics on the device.  The
tree, the M-step and mixup are host numpy, in the JAX package's order and
with its seeds, so the same inputs give the same model.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import TriTrainOptions
from ..data.lang import Lang
from ..fst.hclg import TrainingGraphCompiler
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.treebuild import GaussStats, acc_tree_stats, build_tree
from ..utils.logging import get_logger

from ..device import ieee_fp32_entry, resolve_device
from ..ops import gmm_kernels as K
from ..utils import profiling
from .align import AlignmentSet
from .train_mono import TrainedModel, _batchify, save_model

log = get_logger()


def init_model_from_tree_stats(tree, tree_stats: dict, min_variance=0.001) -> AmDiagGmm:
    """gmm-init-model: each leaf pdf = 1 Gaussian from its pooled stats."""
    dim = len(next(iter(tree_stats.values())).sum_x)
    per_pdf = [GaussStats(dim) for _ in range(tree.num_pdfs)]
    total = GaussStats(dim)
    for (window, pdf_class), st in tree_stats.items():
        pdf = tree.map(window, pdf_class)
        per_pdf[pdf].add(st)
        total.add(st)
    glob_mean = total.sum_x / max(total.count, 1.0)
    glob_var = np.maximum(total.sum_x2 / max(total.count, 1.0) - glob_mean ** 2,
                          min_variance)
    miv = np.zeros((tree.num_pdfs, 1, dim), np.float32)
    iv = np.ones((tree.num_pdfs, 1, dim), np.float32)
    w = np.ones((tree.num_pdfs, 1), np.float32)
    for p, st in enumerate(per_pdf):
        if st.count > 2.0:
            mean = st.sum_x / st.count
            var = np.maximum(st.sum_x2 / st.count - mean * mean, min_variance)
        else:
            mean, var = glob_mean, glob_var
        iv[p, 0] = (1.0 / var).astype(np.float32)
        miv[p, 0] = (mean / var).astype(np.float32)
    return AmDiagGmm(miv, iv, w)


def host_feats(feats: torch.Tensor, num_frames) -> list[np.ndarray]:
    """``[B, T, D]`` padded features -> one float32 ``[T_u, D]`` array per
    utterance on the host (one copy of the batch)."""
    x = feats.cpu().numpy()
    return [x[i, :n] for i, n in enumerate(num_frames)]


def converted_alignments(utts: list, prev_alignments: dict, prev_trans_model: TransitionModel,
                         trans_model: TransitionModel, t_max: int, opts: TriTrainOptions):
    """convert-ali: the previous stage's alignments in the new transition
    model's ids -> (tids [B, T], weights [B, T]), weight 1 on aligned frames."""
    tids = np.zeros((len(utts), t_max), np.int32)
    weights = np.zeros((len(utts), t_max), np.float32)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            conv = prev_trans_model.convert_alignment(
                a, trans_model, opts.context_width, opts.central_position)
            tids[i, : len(conv)] = conv
            weights[i, : len(conv)] = 1.0
    return tids, weights


def training_graphs(lang: Lang, tree, trans_model: TransitionModel, transcripts: dict,
                    utts: list, opts: TriTrainOptions, device, stage: str) -> AlignmentSet:
    """The utterances' training graphs over ``tree`` as an alignment set on
    ``device``; which aligner they take, and why, goes to the log."""
    compiler = TrainingGraphCompiler(lang, tree, trans_model,
                                     opts.transition_scale, opts.self_loop_scale)
    aset = AlignmentSet.from_fsts(compiler.compile_batch([transcripts[u] for u in utts]),
                                  trans_model, device=device)
    log.info("%s: graphs compiled (max states=%d, max arcs=%d); aligner: %s", stage,
             max(g.num_states for g in aset.graphs), max(g.num_arcs for g in aset.graphs),
             aset.aligner)
    return aset


def silence_pdfs_of(lang: Lang, tree) -> list[int]:
    return sorted({pdf for p in lang.silence_phone_ids
                   for c in range(lang.topo.num_pdf_classes(p))
                   for pdf in tree.possible_pdfs(p, c)})


@ieee_fp32_entry
def realign(aset: AlignmentSet, am: AmDiagGmm, feats: torch.Tensor, num_frames,
            tids: np.ndarray, weights: np.ndarray, silence_pdfs: list,
            opts: TriTrainOptions, stage: str, names: list) -> None:
    """Viterbi realignment of every utterance (K2, then K4 or the generic
    aligner), written into ``tids`` and ``weights`` in place."""
    with profiling.span("realign"):
        with profiling.span("align.prepare"):
            align_am = (am.boost_silence(silence_pdfs, opts.boost_silence)
                        if opts.boost_silence != 1.0 else am)
            params = K.pack_gmm(align_am, aset.device)
        aset.align_feats_to_tids(params, feats, num_frames, tids, weights, stage, names,
                                 acoustic_scale=opts.acoustic_scale)


@ieee_fp32_entry
def e_step(am: AmDiagGmm, trans_model: TransitionModel, x: torch.Tensor,
           tids: np.ndarray, weights: np.ndarray):
    """E-step statistics of an alignment over features ``x [N, D]`` on the
    device: K6 for the GMM, a deterministic segment sum for the transitions.
    Returns (occ, mean_acc, var_acc, transition stats) as numpy and ll."""
    dev = x.device
    tflat, wflat = tids.reshape(-1), weights.reshape(-1)
    with profiling.span("estep"):
        with profiling.span("estep.gmm"):
            occ, macc, vacc, ll = K.acc_gmm_stats_chunked(
                K.pack_gmm(am, dev), x, trans_model.tid2pdf[tflat], trans_model.tree.num_pdfs,
                wflat)
        num_tids = trans_model.num_transition_ids
        # bincount on the card reads the ids' largest value back before the copy
        with profiling.span("estep.transitions"), \
                profiling.host_wait("transition_stats", 4 * (num_tids + 1)):
            tstats = K.acc_transition_stats(torch.from_numpy(tflat).to(dev), num_tids,
                                            torch.from_numpy(wflat).to(dev)).cpu().numpy()
    return occ, macc, vacc, tstats, ll


def m_step(am: AmDiagGmm, trans_model: TransitionModel, stats, num_gauss: int,
           opts: TriTrainOptions, seed: int) -> None:
    """M-step and mixup (host numpy), in place."""
    occ, macc, vacc, tstats, _ll = stats
    with profiling.span("mstep"):
        with profiling.span("mstep.gmm"):
            am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, opts.min_variance)
        with profiling.span("mstep.mixup"):
            am.split_to_target(num_gauss, occ, power=opts.power, seed=seed)
        with profiling.span("mstep.transitions"):
            trans_model.mle_update(tstats)


@ieee_fp32_entry
def train_tri(feats_by_utt: dict, transcripts: dict, prev_alignments: dict,
              lang: Lang, opts: TriTrainOptions = TriTrainOptions(),
              prev_trans_model: TransitionModel | None = None,
              out_dir: str | Path | None = None, *, device=None) -> TrainedModel:
    """``feats_by_utt``: utt -> [T, D] features (tensors or arrays);
    ``prev_alignments``: utt -> tids from the previous stage's model
    (``prev_trans_model``; e.g. the monophone system)."""
    if prev_trans_model is None:
        raise ValueError("prev_trans_model: the model of prev_alignments is needed")
    device = resolve_device(device)
    utts = sorted(feats_by_utt)
    feats, num_frames = _batchify([feats_by_utt[u] for u in utts], device)
    b, t_max, dim = feats.shape
    n_ctx, p_ctx = opts.context_width, opts.central_position

    # ---- tree building (stages -3..-1 of train_deltas) ---------------------
    sil = set(lang.silence_phone_ids)
    tree_stats = acc_tree_stats(prev_alignments,
                                dict(zip(utts, host_feats(feats, num_frames))),
                                prev_trans_model, n_ctx, p_ctx, ci_phones=sil)
    tree = build_tree(tree_stats, lang, n_ctx, p_ctx, num_leaves=opts.num_leaves,
                      cluster_thresh=opts.cluster_thresh)
    trans_model = TransitionModel(lang.topo, tree)
    am = init_model_from_tree_stats(tree_stats=tree_stats, tree=tree,
                                    min_variance=opts.min_variance)
    log.info("train_tri: tree has %d leaves (asked %d); %d tids",
             tree.num_pdfs, opts.num_leaves, trans_model.num_transition_ids)

    tids, weights = converted_alignments(utts, prev_alignments, prev_trans_model,
                                         trans_model, t_max, opts)
    aset = training_graphs(lang, tree, trans_model, transcripts, utts, opts, device,
                           "train_tri")
    silence_pdfs = silence_pdfs_of(lang, tree)
    x = feats.reshape(b * t_max, dim)

    num_gauss = am.num_gauss
    inc_gauss = max((opts.totgauss - num_gauss) // opts.max_iter_inc, 0)
    for it in range(1, opts.num_iters + 1):
        if it in opts.realign_iters:
            realign(aset, am, feats, num_frames, tids, weights, silence_pdfs, opts,
                    "train_tri realign", utts)
        stats = e_step(am, trans_model, x, tids, weights)
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        m_step(am, trans_model, stats, num_gauss, opts, seed=1000 + it)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_tri iter %d: loglike/frame %.4f, num_gauss %d",
                     it, stats[4] / max(float(weights.sum()), 1.0), am.num_gauss)

    model = TrainedModel(am, trans_model, tree, lang, aset.aligner)
    if out_dir:
        save_model(Path(out_dir), am, trans_model, tree)
    return model

"""Flat-start monophone GMM training (EM with Viterbi realignment).

Port of ``voicebridge_tpu/steps/train_mono.py`` (the reference's
``TrainGmmMono``):

    flat start (global mean/var)  ->  graphs  ->  equal alignment pass-0  ->
    EM loop: [realign on schedule] -> E-step stats -> M-step + mixup

Features stay on ``device`` for the whole run.  Realignment runs K2
(emissions) and K4 (banded Viterbi and backtrace) through
``AlignmentSet.align_feats``; the E-step runs K6 through
``acc_gmm_stats_chunked``.  Graph compilation, the equal alignment, the
M-step and mixup are the JAX package's host numpy code, shared by import
(``TrainingGraphCompiler``, ``AmDiagGmm``, ``TransitionModel``) or copied
(``equal_align``), so both packages make the same choices from the same
numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from voicebridge_tpu.config import MonoTrainOptions
from voicebridge_tpu.data.lang import Lang
from voicebridge_tpu.fst.hclg import TrainingGraphCompiler
from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu.models.transition import TransitionModel
from voicebridge_tpu.models.tree import MonophoneTree
from voicebridge_tpu.utils.logging import get_logger

from ..device import resolve_device
from ..ops import gmm_kernels as K
from .align import AlignmentSet, apply_alignments, equal_align

log = get_logger()


@dataclass
class TrainedModel:
    am: AmDiagGmm
    trans_model: TransitionModel
    tree: object
    lang: Lang


def make_mono_tree(lang: Lang, shared_phones: list[list[int]] | None = None) -> MonophoneTree:
    pdf_classes = {p: lang.topo.num_emitting_states(p) for p in lang.topo.phones()}
    if shared_phones is None:
        shared_phones = [[p] for p in sorted(pdf_classes)]
    return MonophoneTree(shared_phones, pdf_classes)


def _batchify(feats_list: list, device) -> tuple[torch.Tensor, np.ndarray]:
    """``[T_u, D]`` features (tensors or arrays) -> (``[B, T_max, D]``
    zero-padded float32 tensor on ``device``, ``[B]`` int32 frame counts)."""
    rows = [torch.as_tensor(f, dtype=torch.float32).to(device) for f in feats_list]
    nf = np.array([r.shape[0] for r in rows], np.int32)
    return torch.nn.utils.rnn.pad_sequence(rows, batch_first=True), nf


def train_mono(feats_by_utt: dict, transcripts: dict[str, list[int]], lang: Lang,
               opts: MonoTrainOptions = MonoTrainOptions(),
               out_dir: str | Path | None = None, checkpoint_every: int = 0,
               resume: bool = True, *, device) -> TrainedModel:
    """``feats_by_utt``: utt -> [T, D] final features (CMVN+deltas applied;
    tensors or arrays); ``transcripts``: utt -> word-id sequence.

    With ``checkpoint_every > 0`` and an ``out_dir``, per-iteration state is
    checkpointed and training resumes from the latest checkpoint when
    re-invoked (``resume=True``)."""
    device = resolve_device(device)
    utts = sorted(feats_by_utt)
    feats, num_frames = _batchify([feats_by_utt[u] for u in utts], device)
    b, t_max, dim = feats.shape

    # ---- flat start: global mean/var over all frames (host, as the JAX
    # package computes them) ----
    tree = make_mono_tree(lang)
    trans_model = TransitionModel(lang.topo, tree)
    all_frames = np.concatenate([feats[i, :n].cpu().numpy()
                                 for i, n in enumerate(num_frames)], axis=0)
    am = AmDiagGmm.flat_start(tree.num_pdfs, all_frames.mean(axis=0), all_frames.var(axis=0))
    log.info("train_mono: %d utts, dim=%d, %d pdfs, %d tids", b, dim,
             tree.num_pdfs, trans_model.num_transition_ids)

    # ---- training graphs ----
    compiler = TrainingGraphCompiler(lang, tree, trans_model,
                                     opts.transition_scale, opts.self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model, device=device)
    log.info("train_mono: graphs compiled (max states=%d, max arcs=%d)",
             max(g.num_states for g in aset.graphs), max(g.num_arcs for g in aset.graphs))

    # ---- pass-0 equal alignment ----
    tids = np.zeros((b, t_max), np.int32)
    weights = np.zeros((b, t_max), np.float32)
    n_fail = 0
    for i, g in enumerate(aset.graphs):
        fr = equal_align(g, int(num_frames[i]), seed=i)
        if fr is None:
            n_fail += 1
            continue
        tids[i, : num_frames[i]] = g.arc_tid[fr]
        weights[i, : num_frames[i]] = 1.0
    if n_fail:
        log.warning("train_mono: %d utterances failed equal alignment", n_fail)

    x = feats.reshape(b * t_max, dim)

    def accumulate():
        tids_flat, weights_flat = tids.reshape(-1), weights.reshape(-1)
        occ, macc, vacc, ll = K.acc_gmm_stats_chunked(
            K.pack_gmm(am, device), x, trans_model.tid2pdf[tids_flat], tree.num_pdfs,
            weights_flat)
        tstats = K.acc_transition_stats(torch.from_numpy(tids_flat).to(device),
                                        trans_model.num_transition_ids,
                                        torch.from_numpy(weights_flat).to(device))
        return occ, macc, vacc, tstats.cpu().numpy(), ll

    # ---- iteration 0: first estimate from the equal alignment ----
    occ, macc, vacc, tstats, ll = accumulate()
    am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, opts.min_variance)
    trans_model.mle_update(tstats)
    log.info("train_mono iter 0: loglike/frame %.4f", ll / max(float(weights.sum()), 1))

    num_gauss = am.num_gauss
    inc_gauss = (opts.totgauss - num_gauss) // opts.max_iter_inc
    silence_pdfs = sorted({tree.map_mono(p, c)
                           for p in lang.silence_phone_ids
                           for c in range(lang.topo.num_pdf_classes(p))})

    # ---- checkpoint/resume ----
    ckpt = None
    start_it = 1
    if out_dir and checkpoint_every:
        from voicebridge_tpu.utils.checkpoint import TrainCheckpoint

        ckpt = TrainCheckpoint(Path(out_dir) / "checkpoints")
        if resume:
            state = ckpt.latest()
            if state is not None:
                am = state["am"]
                trans_model.log_probs = state["trans_log_probs"]
                tids = state["tids"]
                weights = state["weights"]
                num_gauss = state["meta"].get("num_gauss_target", num_gauss)
                start_it = state["iteration"] + 1
                log.info("train_mono: resumed from iteration %d", state["iteration"])

    # ---- EM loop ----
    for it in range(start_it, opts.num_iters + 1):
        if it in opts.realign_iters:
            align_am = (am.boost_silence(silence_pdfs, opts.boost_silence)
                        if opts.boost_silence != 1.0 else am)
            # exact Viterbi (no pruning): the reference's beam/retry_beam
            # only bounds token-passing cost on a CPU
            results = aset.align_feats(K.pack_gmm(align_am, device), feats, num_frames,
                                       acoustic_scale=opts.acoustic_scale, beam=1e9)
            apply_alignments(results, tids, weights, num_frames, "train_mono realign",
                             names=utts)

        occ, macc, vacc, tstats, ll = accumulate()
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, opts.min_variance)
        am.split_to_target(num_gauss, occ, power=opts.power,
                           perturb_factor=opts.perturb_factor, seed=it)
        trans_model.mle_update(tstats)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_mono iter %d: loglike/frame %.4f, num_gauss %d",
                     it, ll / max(float(weights.sum()), 1), am.num_gauss)
        if ckpt is not None and it % checkpoint_every == 0:
            ckpt.save(it, am, trans_model.log_probs, tids, weights,
                      {"num_gauss_target": num_gauss})

    model = TrainedModel(am, trans_model, tree, lang)
    if out_dir:
        save_model(Path(out_dir), am, trans_model, tree)
    return model


def save_model(out_dir: Path, am: AmDiagGmm, trans_model: TransitionModel,
               tree, iteration: int | None = None) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f".{iteration}" if iteration is not None else ""
    am.save(out_dir / f"final{suffix}.am.npz")
    trans_model.save(out_dir / f"final{suffix}.tm.json")
    tree.save(out_dir / f"tree{suffix}.json")

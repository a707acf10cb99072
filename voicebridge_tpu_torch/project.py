"""Top-level project API: the voicebridge_tpu equivalent of the reference's
public DLL surface.

Counterparts: ``VoiceBridge.h`` (umbrella API, L7) + the ``Params`` global
path registry (``kaldi-win/scr/Params.h:17-52``) + the examples' incremental
recompute helpers (``NeedToRetrainModel``/``NeedToDecode``,
``TestDll/ExamplesUtil.cpp:16-53``).

Port of ``voicebridge_tpu/project.py``: the same methods and directory
layout, with every stage on the project's ``device`` (``None``: the card,
``cuda:0``; ``"cpu"`` for the plain versions).  Features are kept in
memory as tensors on that device; the files (feature archives as float32
numpy, models, HCLG, lang and data tables) are the JAX package's formats,
so a project directory written by one package is read by the other.

A :class:`Project` owns a directory layout

    <root>/data/{train,test}/...     prepared tables
    <root>/data/local/dict           lexicon
    <root>/lang/                     phones/words/topo/L
    <root>/feats/...                 feature archives
    <root>/exp/<model>/              trained models
    <root>/exp/<model>/graph/        HCLG
    <root>/exp/<model>/decode/       decode results + WER

and exposes the reference's pipeline calls (PrepareData, PrepareDict,
PrepareLang, MakeMfcc+CMVN, TrainGmmMono, TrainDeltas, TrainLdaMllt,
TrainSat, MkGraph, Decode, DecodeFmllr, scoring) as methods.  Each stage
skips recomputation when its outputs are newer than its inputs (mtime-based,
like the reference), unless ``force``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .config import (DecodeOptions, DeltaOptions, FmllrDecodeOptions,
                     LangOptions, LmOptions, MfccOptions, MonoTrainOptions,
                     TriTrainOptions)
from .data.dict import prepare_dict as _prepare_dict, read_ref_dict
from .data.lang import Lang, prepare_lang as _prepare_lang
from .data.prepare import DataDir, prepare_data as _prepare_data
from .device import ieee_fp32_entry, resolve_device
from .fst.core import Fst
from .fst.hclg import mkgraph as _mkgraph
from .lm.arpa import ArpaModel, arpa_to_fst
from .models.gmm import AmDiagGmm
from .models.transition import TransitionModel
from .models.tree import load_tree
from .steps.align import align_utterances
from .steps.decode import Decoder
from .steps.decode_fmllr import decode_fmllr as _decode_fmllr
from .ops.features import add_deltas_batch
from .steps.make_feats import (apply_feature_chain, compute_cmvn, compute_mfcc,
                               pad_features)
from .steps.score import SweepResult, compute_wer_set, score_sweep
from .steps.train_lda_mllt import lda_decode_feats, train_lda_mllt as _train_lda_mllt
from .steps.train_mono import TrainedModel, train_mono as _train_mono
from .steps.train_sat import SatModel, train_sat as _train_sat
from .steps.train_tri import train_tri as _train_tri
from .utils.logging import get_logger, init_twin_log

log = get_logger()


def _newer(outputs: list[Path], inputs: list[Path]) -> bool:
    """True if every output exists and is newer than every input
    (NeedToRetrainModel logic, inverted)."""
    if not outputs or not all(p.exists() for p in outputs):
        return False
    out_m = min(p.stat().st_mtime for p in outputs)
    in_m = max((p.stat().st_mtime for p in inputs if p.exists()), default=0.0)
    return out_m >= in_m


class Project:
    def __init__(self, root: str | Path, waves_dir: str | Path | None = None,
                 ref_dict: str | Path | None = None, name: str = "task",
                 oov_word: str = "<UNK>", *, device=None):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.waves_dir = Path(waves_dir) if waves_dir else self.root / "waves"
        self.ref_dict_path = Path(ref_dict) if ref_dict else None
        self.name = name
        self.oov_word = oov_word
        self.data_dir = self.root / "data"
        self.lang_dir = self.root / "lang"
        self.exp_dir = self.root / "exp"
        self.frame_shift = 0.01  # updated by make_features from frame opts
        init_twin_log(self.root / "General.log")
        # in-memory caches
        self._train: DataDir | None = None
        self._test: DataDir | None = None
        self._arpa: ArpaModel | None = None
        self._lang: Lang | None = None
        self._feats: dict = {}

    # ------------------------------------------------------------------ data
    def prepare_data(self, percentage_train: int = 90, transc_ext: str = ".txt",
                     order_ngram: int = 3, idtype: int = 1,
                     force: bool = False):
        out = self.data_dir
        marker = out / "train" / "wav.scp"
        if not force and _newer([marker], list(self.waves_dir.rglob("*.wav"))):
            log.info("prepare_data: up to date, skipping")
            self._load_data()
            return self
        train, test, arpa, vocab = _prepare_data(
            self.waves_dir, percentage_train, transc_ext, idtype,
            LmOptions(order=order_ngram), out_dir=out)
        self._train, self._test, self._arpa = train, test, arpa
        return self

    def _load_data(self):
        from .utils.io import read_keyed_text

        if self._train is None:
            for split in ("train", "test"):
                d = DataDir()
                base = self.data_dir / split
                d.wav_paths = {k: Path(v[0]) for k, v in
                               read_keyed_text(base / "wav.scp").items()}
                d.text = read_keyed_text(base / "text")
                d.utt2spk = {k: v[0] for k, v in
                             read_keyed_text(base / "utt2spk").items()}
                setattr(self, "_train" if split == "train" else "_test", d)
            self._arpa = ArpaModel.read(self.data_dir / "task.arpabo")

    @property
    def train_data(self) -> DataDir:
        self._load_data()
        return self._train

    @property
    def test_data(self) -> DataDir:
        self._load_data()
        return self._test

    @property
    def arpa(self) -> ArpaModel:
        self._load_data()
        return self._arpa

    # ------------------------------------------------------------- dict/lang
    def prepare_dict_and_lang(self, silence_phones=("SIL",),
                              optional_silence="SIL",
                              lang_opts: LangOptions | None = None,
                              force: bool = False):
        lang_opts = lang_opts or LangOptions(oov_word=self.oov_word)
        marker = self.lang_dir / "meta.json"
        if not force and marker.exists():
            self._lang = Lang.load(self.lang_dir)
            log.info("prepare_lang: loaded existing lang dir")
            return self
        vocab = sorted({w for u in self.train_data.utts
                        for w in self.train_data.text[u]} |
                       {w for u in self.test_data.utts
                        for w in self.test_data.text[u]})
        ref = read_ref_dict(self.ref_dict_path) if self.ref_dict_path else {}
        if ref:
            lexicon, _g2p = _prepare_dict(vocab, ref, list(silence_phones),
                                          optional_silence, self.oov_word)
        else:
            # grapheme fallback: each word spelled as letters (for tests and
            # quick bootstrapping without a reference dictionary)
            lexicon = {w: [(1.0, tuple(w))] for w in vocab}
        self._lang = _prepare_lang(lexicon, list(silence_phones),
                                   optional_silence, lang_opts)
        self._lang.save(self.lang_dir)
        return self

    def set_lexicon(self, lexicon: dict, silence_phones=("SIL",),
                    optional_silence="SIL", lang_opts: LangOptions | None = None):
        """Directly provide a lexicon (word -> [(prob, phones)])."""
        lang_opts = lang_opts or LangOptions(oov_word=self.oov_word)
        self._lang = _prepare_lang(lexicon, list(silence_phones),
                                   optional_silence, lang_opts)
        self._lang.save(self.lang_dir)
        return self

    @property
    def lang(self) -> Lang:
        if self._lang is None:
            self._lang = Lang.load(self.lang_dir)
        return self._lang

    # --------------------------------------------------------------- features
    @ieee_fp32_entry
    def make_features(self, mfcc_opts: MfccOptions | None = None,
                      force: bool = False):
        """MFCC + per-speaker CMVN for train and test on the project's
        device; cached in memory (tensors there) and on disk (float32
        feature archives)."""
        from .utils.io import ArrayArchive, write_archive

        mfcc_opts = mfcc_opts or MfccOptions()
        self.frame_shift = mfcc_opts.frame_opts.frame_shift_ms / 1000.0
        for split, data in (("train", self.train_data), ("test", self.test_data)):
            arc_path = self.root / "feats" / split
            if not force and (arc_path / "index.json").exists():
                arc = ArrayArchive(arc_path)
                self._feats[split] = {u: torch.tensor(arc[u], device=self.device)
                                      for u in arc.keys()}
                continue
            from .data.prepare import load_waves

            waves = load_waves(data,
                               expected_rate=mfcc_opts.frame_opts.samp_freq)
            mfcc = compute_mfcc(waves, mfcc_opts, device=self.device)
            cmvn = compute_cmvn(mfcc, data.utt2spk)
            feats = apply_feature_chain(mfcc, data.utt2spk, cmvn, deltas=None)
            write_archive(arc_path, {u: f.cpu().numpy() for u, f in feats.items()})
            self._feats[split] = feats
        return self

    def feats(self, split: str, kind: str = "cmvn") -> dict:
        """kind: 'cmvn' (13-d) or 'delta' (39-d)."""
        base = self._feats[split]
        if kind == "cmvn":
            return base
        if kind == "delta":
            # deltas only (CMVN already applied), on the features' device
            utts = sorted(base)
            out = add_deltas_batch(*pad_features(base, utts), DeltaOptions())
            return {u: out[i, : base[u].shape[0]] for i, u in enumerate(utts)}
        raise ValueError(kind)

    def transcripts(self, split: str = "train") -> dict:
        data = self.train_data if split == "train" else self.test_data
        oov = self.lang.words.get(self.oov_word)
        return {u: [self.lang.words.get(w, oov) for w in data.text[u]]
                for u in data.utts}

    # --------------------------------------------------------------- training
    @ieee_fp32_entry
    def train_mono(self, opts: MonoTrainOptions | None = None,
                   name: str = "mono", force: bool = False) -> TrainedModel:
        out = self.exp_dir / name
        if not force and (out / "final.am.npz").exists():
            log.info("train_mono: loading existing %s", out)
            return self.load_model(name)
        model = _train_mono(self.feats("train", "delta"), self.transcripts(),
                            self.lang, opts or MonoTrainOptions(), out_dir=out,
                            device=self.device)
        return model

    def _train_feats(self, final_mat: np.ndarray | None) -> dict:
        """Training features in the model's space: spliced+LDA-projected
        when ``final_mat`` is given (the reference's AlignSi/TrainSat
        `final.mat` auto-detection, ``align_si.cpp``), else delta+delta2."""
        if final_mat is not None:
            return lda_decode_feats(self.feats("train", "cmvn"), final_mat,
                                    device=self.device)
        return self.feats("train", "delta")

    @ieee_fp32_entry
    def align(self, model: TrainedModel, boost_silence: float = 1.0,
              final_mat: np.ndarray | None = None) -> dict:
        silence_pdfs = sorted({pdf for p in self.lang.silence_phone_ids
                               for c in range(self.lang.topo.num_pdf_classes(p))
                               for pdf in model.tree.possible_pdfs(p, c)})
        return align_utterances(model.am, model.trans_model, self.lang,
                                self._train_feats(final_mat),
                                self.transcripts(), acoustic_scale=0.1,
                                boost_silence=boost_silence,
                                silence_pdfs=silence_pdfs, device=self.device)

    @ieee_fp32_entry
    def train_tri(self, prev: TrainedModel, alignments: dict,
                  opts: TriTrainOptions | None = None, name: str = "tri1",
                  force: bool = False) -> TrainedModel:
        out = self.exp_dir / name
        if not force and (out / "final.am.npz").exists():
            return self.load_model(name)
        return _train_tri(self.feats("train", "delta"), self.transcripts(),
                          alignments, self.lang, opts or TriTrainOptions(),
                          prev_trans_model=prev.trans_model, out_dir=out,
                          device=self.device)

    @ieee_fp32_entry
    def train_lda_mllt(self, prev: TrainedModel, alignments: dict,
                       opts: TriTrainOptions | None = None,
                       name: str = "tri2b", force: bool = False):
        out = self.exp_dir / name
        if not force and (out / "final.am.npz").exists():
            model = self.load_model(name)
            mat = np.load(out / "final.mat.npy")
            return model, mat
        return _train_lda_mllt(self.feats("train", "cmvn"), self.transcripts(),
                               alignments, self.lang,
                               opts or TriTrainOptions(),
                               prev_trans_model=prev.trans_model, out_dir=out,
                               device=self.device)

    @ieee_fp32_entry
    def train_sat(self, prev: TrainedModel, alignments: dict,
                  opts: TriTrainOptions | None = None, name: str = "tri3b",
                  force: bool = False,
                  final_mat: np.ndarray | None = None) -> SatModel:
        """SAT/fMLLR training.  With ``final_mat``, trains over the
        spliced+LDA(+MLLT) feature space — the reference's tri3b
        (LDA+MLLT+SAT, ``LibriSpeech.cpp:514-543``); without it, over
        delta features — the reference's tri3c (DELTA+SAT)."""
        out = self.exp_dir / name
        if not force and (out / "final.am.npz").exists() and \
                (out / "final.alimdl.npz").exists():
            log.info("train_sat: loading existing %s", out)
            return self.load_sat_model(name)
        return _train_sat(self._train_feats(final_mat),
                          self.train_data.utt2spk, self.transcripts(),
                          alignments, prev.am, self.lang,
                          opts or TriTrainOptions(),
                          prev_trans_model=prev.trans_model, out_dir=out,
                          device=self.device)

    def load_sat_model(self, name: str) -> SatModel:
        """Reload a saved SAT system.  Training-speaker transforms are not
        persisted (nothing downstream consumes them — decode_fmllr estimates
        the TEST speakers' transforms from its own SI pass), so the reloaded
        SatModel carries an empty transforms dict."""
        model = self.load_model(name)
        alimdl = AmDiagGmm.load(self.exp_dir / name / "final.alimdl.npz")
        return SatModel(model=model, alimdl=alimdl, transforms={})

    def load_model(self, name: str) -> TrainedModel:
        out = self.exp_dir / name
        am = AmDiagGmm.load(out / "final.am.npz")
        tree = load_tree(out / "tree.json")
        tm = TransitionModel(self.lang.topo, tree)
        tm.load_probs(out / "final.tm.json")
        return TrainedModel(am, tm, tree, self.lang, aligner="")

    # ----------------------------------------------------------------- decode
    def mkgraph(self, model: TrainedModel, name: str = "mono") -> Fst:
        graph_path = self.exp_dir / name / "graph" / "HCLG.fst.npz"
        if graph_path.exists() and _newer(
                [graph_path], [self.exp_dir / name / "final.am.npz"]):
            return Fst.load(graph_path)
        g = arpa_to_fst(self.arpa, self.lang.words.id,
                        self.lang.word_disambig_id)
        hclg = _mkgraph(self.lang, model.tree, model.trans_model, g)
        graph_path.parent.mkdir(parents=True, exist_ok=True)
        hclg.save(graph_path)
        return hclg

    def _test_batch(self, feats_by_utt: dict):
        utts = sorted(feats_by_utt)
        return (utts, *pad_features(feats_by_utt, utts))

    @ieee_fp32_entry
    def decode(self, model: TrainedModel, hclg: Fst, feat_kind: str = "delta",
               final_mat: np.ndarray | None = None,
               opts: DecodeOptions | None = None,
               out_name: str | None = None) -> SweepResult:
        """Decode the test set with an LMWT sweep; returns the best WER.
        With ``out_name``, writes the decode artifacts (transcriptions, WER
        tables, per-utterance details) under exp/<out_name>/decode/ like the
        reference's decode directory."""
        opts = opts or DecodeOptions()
        if final_mat is not None:
            test_feats = lda_decode_feats(self.feats("test", "cmvn"), final_mat,
                                          device=self.device)
        else:
            test_feats = self.feats("test", feat_kind)
        utts, feats, nf = self._test_batch(test_feats)
        dec = Decoder(hclg, model.trans_model, model.am, opts, device=self.device)
        lmwts = list(range(opts.min_lmwt, opts.max_lmwt + 1))
        # the reference's scoring design: one lattice decode, host-side
        # LatticeScale x AddPenalty per (LMWT, WIP) grid point
        # (score_kaldi_wer.cpp:93-111, 279-356)
        sweep, lats = dec.decode_sweep_lattice(utts, feats, nf, lmwts,
                                               opts.word_ins_penalties)
        refs = {u: list(self.test_data.text[u]) for u in utts}
        hyps_by = {k: {r.utt: [self.lang.words.sym(x) for x in r.words]
                       for r in rs} for k, rs in sweep.items()}
        result = score_sweep(refs, hyps_by)
        log.info("decode: best %s at LMWT %d WIP %.1f", result.best_wer,
                 result.best_lmwt, result.best_wip)
        if out_name:
            best_key = (result.best_lmwt, result.best_wip)
            self._save_decode_artifacts(out_name, refs,
                                        hyps_by[best_key], result)
            self._save_ctm(out_name, sweep[best_key], model)
            from .steps.diagnostic import lattice_depth_stats
            ds = lattice_depth_stats(lats)
            (self.exp_dir / out_name / "decode" / "lattice_depth.txt").write_text(
                "".join(f"{k} {v}\n" for k, v in ds.items()))
        return result

    def _save_decode_artifacts(self, name: str, refs: dict, hyps: dict,
                               result: SweepResult) -> None:
        """Write transcription/WER artifacts (decode_gmm.cpp:357-376 +
        score_kaldi_wer outputs + wer_per_utt_details)."""
        from .steps.score import per_utt_details, wer_bootstrap_ci
        from .utils.io import write_keyed_text

        out = self.exp_dir / name / "decode"
        out.mkdir(parents=True, exist_ok=True)
        write_keyed_text(out / "transcription.txt",
                         {u: " ".join(h) for u, h in hyps.items()})
        lines = [f"best: {result.best_wer} (LMWT {result.best_lmwt}, "
                 f"WIP {result.best_wip})"]
        for (lmwt, wip), stats in sorted(result.table.items()):
            lines.append(f"LMWT {lmwt} WIP {wip}: {stats}")
        lo, mid, hi = wer_bootstrap_ci(refs, hyps, num_reps=2000)
        lines.append(f"bootstrap 95% CI: [{lo:.2f}, {hi:.2f}] median {mid:.2f}")
        (out / "wer_table.txt").write_text("\n".join(lines) + "\n")
        details = per_utt_details(refs, hyps)
        with open(out / "per_utt_details.txt", "w") as f:
            for u, ops in sorted(details.items()):
                f.write(f"{u} " + " ".join(
                    f"{op}:{r or '*'}->{h or '*'}" for op, r, h in ops) + "\n")

    def _save_ctm(self, name: str, results, model) -> None:
        """Word-level CTM with exact times via positional-phone word
        alignment (lattice-align-words + nbest-to-ctm roles)."""
        if not self.lang.position_dependent:
            return
        from .lat.word_align import align_words_boundary, to_ctm

        rows = []
        for r in sorted(results, key=lambda x: x.utt):
            if not r.tids:
                continue
            words = [self.lang.words.sym(w) for w in r.words]
            segs = align_words_boundary(r.tids, words, model.trans_model,
                                        self.lang)
            if segs is None:
                log.warning("ctm: word alignment failed for %s", r.utt)
                continue
            rows.extend(to_ctm(segs, r.utt, self.frame_shift))
        out = self.exp_dir / name / "decode"
        out.mkdir(parents=True, exist_ok=True)
        (out / "ctm").write_text("\n".join(rows) + ("\n" if rows else ""))

    @ieee_fp32_entry
    def decode_mbr(self, model: TrainedModel, hclg: Fst,
                   feat_kind: str = "delta", nbest: int = 4,
                   opts: DecodeOptions | None = None) -> SweepResult:
        """MBR consensus decoding of the test set (ScoreKaldiWER MBR mode)."""
        opts = opts or DecodeOptions()
        test_feats = self.feats("test", feat_kind)
        utts, feats, nf = self._test_batch(test_feats)
        dec = Decoder(hclg, model.trans_model, model.am, opts, device=self.device)
        results = dec.decode_mbr(utts, feats, nf, nbest=nbest)
        refs = {u: list(self.test_data.text[u]) for u in utts}
        hyps = {r.utt: [self.lang.words.sym(x) for x in r.words]
                for r in results}
        stats = compute_wer_set(refs, hyps)
        out = SweepResult(best_wer=stats,
                          best_lmwt=int(1 / opts.acoustic_scale))
        out.table[(out.best_lmwt, 0.0)] = stats
        log.info("decode_mbr: %s", stats)
        return out

    @ieee_fp32_entry
    def train_full_chain(self, mono_opts: MonoTrainOptions | None = None,
                         tri_opts: TriTrainOptions | None = None) -> dict:
        """The reference's TestLibriSpeech sequence as one call, with the
        reference's model names (``LibriSpeech.cpp:93-94,514-543``):
        mono -> tri1 (deltas) -> tri2b (LDA+MLLT) -> tri3b (LDA+MLLT+SAT,
        trained over tri2b's feature space and alignments) -> tri3c
        (DELTA+SAT).  Returns
        {'mono','tri1','tri2b','tri3b','tri3c','final_mat'} models."""
        mono = self.train_mono(mono_opts, name="mono")
        ali = self.align(mono)
        tri1 = self.train_tri(mono, ali, tri_opts, name="tri1")
        ali1 = self.align(tri1)
        tri2b, final_mat = self.train_lda_mllt(tri1, ali1, tri_opts,
                                               name="tri2b")
        ali2 = self.align(tri2b, final_mat=final_mat)
        tri3b = self.train_sat(tri2b, ali2, tri_opts, name="tri3b",
                               final_mat=final_mat)
        tri3c = self.train_sat(tri1, ali1, tri_opts, name="tri3c")
        return {"mono": mono, "tri1": tri1, "tri2b": tri2b,
                "final_mat": final_mat, "tri3b": tri3b, "tri3c": tri3c}

    @ieee_fp32_entry
    def decode_fmllr(self, sat: SatModel, hclg: Fst,
                     opts: FmllrDecodeOptions | None = None,
                     final_mat: np.ndarray | None = None) -> SweepResult:
        opts = opts or FmllrDecodeOptions()
        if final_mat is not None:  # LDA+MLLT+SAT: test feats in LDA space
            test_feats = lda_decode_feats(self.feats("test", "cmvn"),
                                          final_mat, device=self.device)
        else:
            test_feats = self.feats("test", "delta")
        utts, feats, nf = self._test_batch(test_feats)
        results, _trans = _decode_fmllr(
            hclg, sat.model.trans_model, sat.model.am, sat.alimdl, self.lang,
            utts, feats, nf, self.test_data.utt2spk, opts, device=self.device)
        refs = {u: list(self.test_data.text[u]) for u in utts}
        hyps = {r.utt: [self.lang.words.sym(x) for x in r.words]
                for r in results}
        stats = compute_wer_set(refs, hyps)
        out = SweepResult(best_wer=stats, best_lmwt=int(1 / opts.acoustic_scale))
        out.table[(out.best_lmwt, 0.0)] = stats
        log.info("decode_fmllr: %s", stats)
        return out

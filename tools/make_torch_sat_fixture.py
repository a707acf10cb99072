"""Train an LDA+MLLT+SAT model (tri3b) with the JAX package on the CPU and
save it as the PyTorch port's fMLLR decoding fixture.

    python tools/make_torch_sat_fixture.py [--out voicebridge_tpu_torch/assets/synth_sat]

The recipe is the one of ``tests/test_sat_lda.py``
(``test_lda_mllt_sat_end_to_end``): the speaker corpus
``make_speaker_corpus(4, 6, 2, seed=3)`` at 8 kHz, MFCC without dither,
per-speaker CMVN over train and test, a monophone model on delta features
and its alignments, ``train_lda_mllt`` on the CMVN'd base features (8
iterations, 100 leaves, 300 Gaussians, MLLT at 2 and 4), the tri2b
alignments of the LDA features, then ``train_sat`` on them (fMLLR at 2, 4
and 6), a bigram LM and ``mkgraph``.  Saved with the JAX package's numpy
savers: the AM (``am.npz``), ``final.alimdl.npz``, the HCLG (``hclg.npz``),
the topology, tree and transition model (``topo.json``, ``tree.json``,
``trans.json``), ``final_mat.npy``, ``words.txt``, the JAX package's
``decode_fmllr`` words and scores for the test utterances (exact search,
``fmllr_min_count`` 50) with the test speakers' names (``hyps.json``), and
its final transform of each test speaker (``transforms.npy``, ``[S, 40,
41]`` in the order of ``hyps.json``'s ``speakers``).  The waves are not
saved: ``tests/synth.py`` remakes them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = Path(__file__).resolve().parent.parent
CORPUS = {"num_speakers": 4, "utts_per_speaker": 6, "num_test_per": 2, "seed": 3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "voicebridge_tpu_torch" / "assets" / "synth_sat")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import numpy as np
    from synth import LEXICON, SR, make_speaker_corpus
    from voicebridge_tpu.config import (FmllrDecodeOptions, FrameOptions, LangOptions,
                                        MfccOptions, MonoTrainOptions, TriTrainOptions)
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.hclg import mkgraph
    from voicebridge_tpu.lm.arpa import arpa_to_fst
    from voicebridge_tpu.lm.ngram import estimate_ngram
    from voicebridge_tpu.steps.align import align_utterances
    from voicebridge_tpu.steps.decode_fmllr import decode_fmllr
    from voicebridge_tpu.steps.make_feats import (apply_feature_chain, compute_cmvn,
                                                  compute_mfcc)
    from voicebridge_tpu.steps.train_lda_mllt import lda_decode_feats, train_lda_mllt
    from voicebridge_tpu.steps.train_mono import train_mono
    from voicebridge_tpu.steps.train_sat import train_sat

    train, test, utt2spk = make_speaker_corpus(**CORPUS)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    mfcc = compute_mfcc({u: w for u, (w, _) in {**train, **test}.items()}, opts)
    cmvn = compute_cmvn(mfcc, utt2spk)
    base = apply_feature_chain(mfcc, utt2spk, cmvn, deltas=None)
    delta = apply_feature_chain(mfcc, utt2spk, cmvn)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    transcripts = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    tr_delta = {u: delta[u] for u in train}
    mono = train_mono(tr_delta, transcripts, lang,
                      MonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                       realign_iters=tuple(range(1, 10))))
    ali = align_utterances(mono.am, mono.trans_model, lang, tr_delta, transcripts,
                           acoustic_scale=0.1)
    tri_opts = TriTrainOptions(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                               realign_iters=(2, 4, 6), mllt_iters=(2, 4),
                               fmllr_iters=(2, 4, 6))
    base_train = {u: base[u] for u in train}
    tri2b, final_mat = train_lda_mllt(base_train, transcripts, ali, lang, tri_opts,
                                      prev_trans_model=mono.trans_model)
    lda_train = lda_decode_feats(base_train, final_mat)
    ali2 = align_utterances(tri2b.am, tri2b.trans_model, lang, lda_train, transcripts,
                            acoustic_scale=0.1)
    sat = train_sat(lda_train, utt2spk, transcripts, ali2, tri2b.am, lang, tri_opts,
                    prev_trans_model=tri2b.trans_model)
    model = sat.model
    arpa = estimate_ngram([ws for (_w, ws) in train.values()], order=2)
    hclg = mkgraph(lang, model.tree, model.trans_model,
                   arpa_to_fst(arpa, lang.words.id, lang.word_disambig_id))

    feats = lda_decode_feats({u: base[u] for u in test}, final_mat)
    utts = sorted(feats)
    t_max = max(feats[u].shape[0] for u in utts)
    batch = np.zeros((len(utts), t_max, feats[utts[0]].shape[1]), np.float32)
    nf = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        batch[i, : feats[u].shape[0]] = feats[u]
        nf[i] = feats[u].shape[0]
    res, trans = decode_fmllr(hclg, model.trans_model, model.am, sat.alimdl, lang, utts,
                              batch, nf, utt2spk,
                              FmllrDecodeOptions(beam=1e9, first_beam=1e9,
                                                 fmllr_min_count=50.0))
    hyps = {r.utt: [lang.words.sym(w) for w in r.words] for r in res}
    scores = {r.utt: float(r.score) for r in res}
    speakers = sorted({utt2spk[u] for u in utts})

    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    model.am.save(out / "am.npz")
    sat.alimdl.save(out / "final.alimdl.npz")
    hclg.save(out / "hclg.npz")
    lang.topo.save(out / "topo.json")
    model.tree.save(out / "tree.json")
    model.trans_model.save(out / "trans.json")
    np.save(out / "final_mat.npy", final_mat)
    np.save(out / "transforms.npy", np.asarray(trans, np.float32))
    lang.words.write(out / "words.txt")
    (out / "hyps.json").write_text(json.dumps(
        {"corpus": CORPUS, "samp_freq": SR, "hyps": hyps, "scores": scores,
         "speakers": speakers}, indent=1, sort_keys=True))
    print(f"wrote {out}: {len(hyps)} hypotheses, {model.tree.num_pdfs} pdfs, "
          f"{model.am.num_gauss} Gaussians, HCLG {hclg.num_states} states, "
          f"{len(speakers)} speakers")


if __name__ == "__main__":
    main()

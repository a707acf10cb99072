"""Train an LDA+MLLT triphone model (tri2b) with the JAX package on the CPU
and save it as the PyTorch port's decoding fixture.

    python tools/make_torch_tri_fixture.py [--out voicebridge_tpu_torch/assets/synth_tri2b]

The recipe is the one of ``tests/test_sat_lda.py`` (its ``system`` fixture
and ``test_lda_mllt_end_to_end``): the speaker corpus
``make_speaker_corpus(4, 6, 2, seed=3)`` at 8 kHz, MFCC without dither,
per-speaker CMVN over train and test, a monophone model on delta features
(10 EM iterations to 150 Gaussians) and its alignments, then
``train_lda_mllt`` on the CMVN'd base features (splice +-3, LDA to 40, 8
iterations, 100 leaves, 300 Gaussians, MLLT at 2 and 4), a bigram LM and
``mkgraph``.  Saved with the JAX package's numpy savers: the AM
(``am.npz``), the HCLG (``hclg.npz``), the topology, tree and transition
model (``topo.json``, ``tree.json``, ``trans.json``), ``final_mat.npy``,
``words.txt``, and the JAX package's exact best-path words and scores for
the test utterances (``hyps.json``).  The waves are not saved:
``tests/synth.py`` remakes them.
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
                    default=ROOT / "voicebridge_tpu_torch" / "assets" / "synth_tri2b")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    import numpy as np
    from synth import LEXICON, SR, make_speaker_corpus
    from voicebridge_tpu.config import (DecodeOptions, FrameOptions, LangOptions,
                                        MfccOptions, MonoTrainOptions, TriTrainOptions)
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.hclg import mkgraph
    from voicebridge_tpu.lm.arpa import arpa_to_fst
    from voicebridge_tpu.lm.ngram import estimate_ngram
    from voicebridge_tpu.steps.align import align_utterances
    from voicebridge_tpu.steps.decode import Decoder
    from voicebridge_tpu.steps.make_feats import (apply_feature_chain, compute_cmvn,
                                                  compute_mfcc)
    from voicebridge_tpu.steps.train_lda_mllt import lda_decode_feats, train_lda_mllt
    from voicebridge_tpu.steps.train_mono import train_mono

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
    model, final_mat = train_lda_mllt(
        {u: base[u] for u in train}, transcripts, ali, lang,
        TriTrainOptions(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                        realign_iters=(2, 4, 6), mllt_iters=(2, 4)),
        prev_trans_model=mono.trans_model)
    arpa = estimate_ngram([ws for (_w, ws) in train.values()], order=2)
    hclg = mkgraph(lang, model.tree, model.trans_model,
                   arpa_to_fst(arpa, lang.words.id, lang.word_disambig_id))

    dec = Decoder(hclg, model.trans_model, model.am, DecodeOptions(beam=1e9))
    feats = lda_decode_feats({u: base[u] for u in test}, final_mat)
    utts = sorted(feats)
    t_max = max(feats[u].shape[0] for u in utts)
    batch = np.zeros((len(utts), t_max, feats[utts[0]].shape[1]), np.float32)
    nf = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        batch[i, : feats[u].shape[0]] = feats[u]
        nf[i] = feats[u].shape[0]
    res = dec.decode_batch(utts, batch, nf)
    hyps = {r.utt: [lang.words.sym(w) for w in r.words] for r in res}
    scores = {r.utt: float(r.score) for r in res}

    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    model.am.save(out / "am.npz")
    hclg.save(out / "hclg.npz")
    lang.topo.save(out / "topo.json")
    model.tree.save(out / "tree.json")
    model.trans_model.save(out / "trans.json")
    np.save(out / "final_mat.npy", final_mat)
    lang.words.write(out / "words.txt")
    (out / "hyps.json").write_text(json.dumps(
        {"corpus": CORPUS, "samp_freq": SR, "hyps": hyps, "scores": scores},
        indent=1, sort_keys=True))
    print(f"wrote {out}: {len(hyps)} hypotheses, {model.tree.num_pdfs} pdfs, "
          f"{model.am.num_gauss} Gaussians, HCLG {hclg.num_states} states")


if __name__ == "__main__":
    main()

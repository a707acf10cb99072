"""Parity of the port's monophone training (``steps/train_mono.py``) with the
JAX package's, on the Yes-No corpus of ``tools/make_torch_fixture.py``, on
the CPU.  Both packages get the same features (the JAX package's, as
numpy).

At 0 iterations (flat start, equal alignment, one M-step) and at 2
iterations realigned at 1 and 2, the checkpointed alignments are equal, every
pdf has the same number of Gaussians, weights and transition log-probs agree
within rtol/atol 1e-4, means within an atol of 2e-5 times the largest mean
magnitude (features reach |x| = 35, and the posteriors of split Gaussians are
float32 softmaxes in another order) and variances within rtol 1e-3 (they are
E[x^2] - mean^2, which cancels).  Resuming from the last checkpoint gives
back the same model."""

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import FrameOptions, LangOptions, MfccOptions, MonoTrainOptions
from voicebridge_tpu.data.lang import prepare_lang
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu.steps.train_mono import train_mono as jax_train_mono
from voicebridge_tpu.utils.checkpoint import TrainCheckpoint
from voicebridge_tpu_torch.steps import align as A
from voicebridge_tpu_torch.steps.train_mono import train_mono

from synth import LEXICON, SR, make_corpus

torch.set_num_threads(2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def corpus():
    train, _ = make_corpus(num_train=24, num_test=8, seed=7)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    feats = jax_make_features({u: w for u, (w, _) in train.items()}, {u: u for u in train},
                              opts)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    transcripts = {u: [lang.words.id(w) for w in words] for u, (_, words) in train.items()}
    return feats, transcripts, lang


def _assert_models_close(got, want):
    np.testing.assert_array_equal(got.am.weights > 0, want.am.weights > 0)
    mask = want.am.weights > 0
    means = want.am.means()[mask]
    np.testing.assert_allclose(got.am.means()[mask], means, rtol=0,
                               atol=2e-5 * np.abs(means).max())
    np.testing.assert_allclose(got.am.variances()[mask], want.am.variances()[mask], rtol=1e-3)
    np.testing.assert_allclose(got.am.weights, want.am.weights, **MODEL_TOL)
    np.testing.assert_allclose(got.trans_model.log_probs, want.trans_model.log_probs,
                               **MODEL_TOL)


@pytest.mark.parametrize("iters", [0, 2])
def test_train_mono_matches_jax(corpus, iters, tmp_path):
    feats, transcripts, lang = corpus
    opts = MonoTrainOptions(num_iters=iters, totgauss=200, max_iter_inc=10,
                            realign_iters=(1, 2))
    want = jax_train_mono(feats, transcripts, lang, opts, out_dir=tmp_path / "jax",
                          checkpoint_every=1)
    got = train_mono(feats, transcripts, lang, opts, out_dir=tmp_path / "port",
                     checkpoint_every=1, device="cpu")
    np.testing.assert_array_equal((got.am.weights > 0).sum(axis=1),
                                  (want.am.weights > 0).sum(axis=1))
    _assert_models_close(got, want)
    if iters:
        ours = TrainCheckpoint(tmp_path / "port" / "checkpoints").latest()
        theirs = TrainCheckpoint(tmp_path / "jax" / "checkpoints").latest()
        assert ours["iteration"] == theirs["iteration"] == iters
        np.testing.assert_array_equal(ours["tids"], theirs["tids"])
        np.testing.assert_array_equal(ours["weights"], theirs["weights"])
        # a second call resumes after the last checkpoint: the same model
        again = train_mono(feats, transcripts, lang, opts, out_dir=tmp_path / "port",
                           checkpoint_every=1, device="cpu")
        np.testing.assert_array_equal(again.am.means_invvars, got.am.means_invvars)
    assert (tmp_path / "port" / "final.am.npz").exists()


def test_align_utterances_matches_jax(corpus):
    from voicebridge_tpu.steps.align import align_utterances as jax_align_utterances

    feats, transcripts, lang = corpus
    opts = MonoTrainOptions(num_iters=1, totgauss=100, max_iter_inc=1, realign_iters=(1,))
    model = jax_train_mono(feats, transcripts, lang, opts)
    want = jax_align_utterances(model.am, model.trans_model, lang, feats, transcripts,
                                acoustic_scale=0.1)
    got = A.align_utterances(model.am, model.trans_model, lang, feats, transcripts,
                             acoustic_scale=0.1, device="cpu")
    assert got == want
    assert all(len(got[u]) == feats[u].shape[0] for u in feats)

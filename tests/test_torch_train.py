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

import json

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

from voicebridge_tpu_torch import config as port_config
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.data.lang import prepare_lang as port_prepare_lang
from voicebridge_tpu_torch.testing import assert_models_close

from synth import LEXICON, SR, make_corpus

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus():
    train, _ = make_corpus(num_train=24, num_test=8, seed=7)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    feats = jax_make_features({u: w for u, (w, _) in train.items()}, {u: u for u in train},
                              opts)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    transcripts = {u: [lang.words.id(w) for w in words] for u, (_, words) in train.items()}
    # each package trains from its own lang (equal symbol tables and FSTs)
    port_lang = port_prepare_lang(LEXICON, ["SIL"], "SIL", port_config.LangOptions())
    assert list(port_lang.words.items()) == list(lang.words.items())
    return feats, transcripts, lang, port_lang


def _port_opts(opts):
    return port_config.MonoTrainOptions(**vars(opts))


@pytest.mark.parametrize("iters", [0, 2])
def test_train_mono_matches_jax(corpus, iters, tmp_path):
    feats, transcripts, lang, port_lang = corpus
    opts = MonoTrainOptions(num_iters=iters, totgauss=200, max_iter_inc=10,
                            realign_iters=(1, 2))
    want = jax_train_mono(feats, transcripts, lang, opts, out_dir=tmp_path / "jax",
                          checkpoint_every=1)
    got = train_mono(feats, transcripts, port_lang, _port_opts(opts), out_dir=tmp_path / "port",
                     checkpoint_every=1, device="cpu")
    np.testing.assert_array_equal((got.am.weights > 0).sum(axis=1),
                                  (want.am.weights > 0).sum(axis=1))
    assert_models_close(got, want)
    if iters:
        ours = TrainCheckpoint(tmp_path / "port" / "checkpoints").latest()
        theirs = TrainCheckpoint(tmp_path / "jax" / "checkpoints").latest()
        assert ours["iteration"] == theirs["iteration"] == iters
        np.testing.assert_array_equal(ours["tids"], theirs["tids"])
        np.testing.assert_array_equal(ours["weights"], theirs["weights"])
        # a second call resumes after the last checkpoint: the same model
        again = train_mono(feats, transcripts, port_lang, _port_opts(opts),
                           out_dir=tmp_path / "port",
                           checkpoint_every=1, device="cpu")
        np.testing.assert_array_equal(again.am.means_invvars, got.am.means_invvars)
    assert (tmp_path / "port" / "final.am.npz").exists()


def test_align_utterances_matches_jax(corpus, tmp_path):
    from voicebridge_tpu.steps.align import align_utterances as jax_align_utterances

    feats, transcripts, lang, port_lang = corpus
    opts = MonoTrainOptions(num_iters=1, totgauss=100, max_iter_inc=1, realign_iters=(1,))
    model = jax_train_mono(feats, transcripts, lang, opts)
    want = jax_align_utterances(model.am, model.trans_model, lang, feats, transcripts,
                                acoustic_scale=0.1)
    # the JAX-trained model goes to the port as arrays and json objects
    am = convert.am_from_arrays(model.am.means_invvars, model.am.inv_vars, model.am.weights)
    model.lang.topo.save(tmp_path / "topo.json")
    model.tree.save(tmp_path / "tree.json")
    model.trans_model.save(tmp_path / "trans.json")
    tm = convert.transition_model_from_json(
        *[json.loads((tmp_path / n).read_text()) for n in ("topo.json", "tree.json",
                                                            "trans.json")])
    got = A.align_utterances(am, tm, port_lang, feats, transcripts,
                             acoustic_scale=0.1, device="cpu")
    assert got == want
    assert all(len(got[u]) == feats[u].shape[0] for u in feats)

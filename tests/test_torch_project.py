"""The port's ``Project`` (``voicebridge_tpu_torch/project.py``) and its
host modules against the JAX package's, on the CPU.

Data preparation, the dictionary with G2P, the lang directory and the
synthesized corpus are numpy copies: identical files and bit-equal waves.
Features are held to the JAX package's at the frontend's tolerance (rtol
2e-4, atol 2e-3).  A JAX ``Project``'s directory (data, lang, features and
the monophone model trained with ``tests/test_project.py``'s options), read
by the port's ``Project``, decodes to the same words, best (LMWT, WIP), WER,
transcription, CTM and lattice depths, and aligns to the same alignments.
The port's own ``Project`` trains a monophone model through
``examples/yesno_synthetic_torch.py`` that reaches the JAX test's WER gate.
"""

import filecmp
import importlib
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import (DecodeOptions as JaxDecodeOptions, LmOptions as JaxLmOptions,
                                    MonoTrainOptions as JaxMonoTrainOptions)
from voicebridge_tpu.data import dict as jax_dict
from voicebridge_tpu.data import prepare as jax_prepare
from voicebridge_tpu.project import Project as JaxProject
from voicebridge_tpu.steps.diagnostic import report_alignment_diagnostics as jax_diagnostics
from voicebridge_tpu import testing as jax_testing
from voicebridge_tpu.utils.io import ArrayArchive as JaxArchive

from voicebridge_tpu_torch.config import DecodeOptions, LmOptions, MonoTrainOptions
from voicebridge_tpu_torch.data import dict as port_dict
from voicebridge_tpu_torch.data import prepare as port_prepare
from voicebridge_tpu_torch.project import Project
from voicebridge_tpu_torch.steps.diagnostic import report_alignment_diagnostics
from voicebridge_tpu_torch import testing as port_testing
from voicebridge_tpu_torch.testing.corpus import write_corpus
from voicebridge_tpu_torch.utils.io import ArrayArchive
from voicebridge_tpu_torch.utils.wave import write_wave

from synth import LEXICON, make_corpus, make_speaker_corpus

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parent.parent
FEATS_TOL = dict(rtol=2e-4, atol=2e-3)
MFCC_8K = dict(frame_opts=dict(samp_freq=8000.0, dither=0.0))
# words of the LibriSpeech-shaped corpus below left out of the reference
# dictionary, so that G2P pronounces them
G2P_WORDS = ("CITY", "HORSE", "RIVER")


def _mfcc(cfg):
    return cfg.MfccOptions(frame_opts=cfg.FrameOptions(**MFCC_8K["frame_opts"]))


@pytest.fixture(scope="module")
def yesno_waves(tmp_path_factory):
    """``tests/test_project.py``'s corpus on disk (one speaker directory)."""
    waves = tmp_path_factory.mktemp("yesno") / "waves"
    train, test = make_corpus(num_train=18, num_test=6, seed=21)
    for utt, (wave, words) in {**train, **test}.items():
        write_wave(waves / "g" / f"{utt}.wav", 8000, wave)
        (waves / "g" / f"{utt}.txt").write_text(" ".join(words))
    return waves


@pytest.fixture(scope="module")
def speakers_waves(tmp_path_factory):
    waves = tmp_path_factory.mktemp("speakers") / "waves"
    train, test, utt2spk = make_speaker_corpus(num_speakers=4, utts_per_speaker=3,
                                               num_test_per=1, seed=5)
    for utt, (wave, words) in {**train, **test}.items():
        write_wave(waves / utt2spk[utt] / f"{utt}.wav", 8000, wave)
        (waves / utt2spk[utt] / f"{utt}.txt").write_text(" ".join(words))
    return waves


@pytest.fixture(scope="module")
def librispeech_corpus():
    """The LibriSpeech-shaped corpus of both packages, 2 speakers."""
    kw = dict(num_speakers=2, utts_per_speaker=2, num_test_per=1, seed=0)
    return port_testing.make_corpus(**kw), jax_testing.make_corpus(**kw)


@pytest.fixture(scope="module")
def jax_project(yesno_waves, tmp_path_factory):
    """``tests/test_project.py``'s project, mono trained, decoded with
    ``out_name`` and aligned by the JAX package."""
    import voicebridge_tpu.config as cfg

    proj = JaxProject(tmp_path_factory.mktemp("jax_proj"), waves_dir=yesno_waves)
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=1)
    proj.set_lexicon(LEXICON)
    proj.make_features(_mfcc(cfg))
    mono = proj.train_mono(JaxMonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                               realign_iters=tuple(range(1, 10))), name="mono")
    res = proj.decode(mono, proj.mkgraph(mono, "mono"), opts=JaxDecodeOptions(beam=1e9),
                      out_name="mono")
    return proj, mono, res, proj.align(mono)


@pytest.fixture(scope="module")
def port_on_jax_dir(jax_project, yesno_waves, tmp_path_factory):
    """A port ``Project`` over a copy of the JAX project's directory: its
    data, lang, features and models as the JAX package wrote them."""
    import voicebridge_tpu_torch.config as cfg

    src = jax_project[0].root
    root = tmp_path_factory.mktemp("port_on_jax")
    for name in ("data", "lang", "feats", "exp"):
        shutil.copytree(src / name, root / name, ignore=shutil.ignore_patterns("decode"))
    proj = Project(root, waves_dir=yesno_waves, device="cpu")
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=1)  # up to date: loads
    proj.make_features(_mfcc(cfg))  # archives exist: loads
    mono = proj.load_model("mono")
    res = proj.decode(mono, proj.mkgraph(mono, "mono"), opts=DecodeOptions(beam=1e9),
                      out_name="mono")
    return proj, mono, res


@pytest.fixture(scope="module")
def yesno_example(tmp_path_factory):
    """``examples/yesno_synthetic_torch.main`` on the CPU: the port's own
    Project from wav files to a trained, decoded monophone model."""
    sys.path.insert(0, str(ROOT / "examples"))
    work = tmp_path_factory.mktemp("yesno_example")
    res = importlib.import_module("yesno_synthetic_torch").main(str(work), device="cpu")
    return work, res


def _tables(out: Path) -> dict:
    return {p.relative_to(out): p.read_bytes() for p in sorted(out.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("corpus,idtype", [("yesno", 1), ("speakers", 0)])
def test_prepare_data_writes_the_same_tables(request, tmp_path, corpus, idtype):
    waves = request.getfixturevalue(f"{corpus}_waves")
    for pkg, mod, opts in (("port", port_prepare, LmOptions), ("jax", jax_prepare, JaxLmOptions)):
        mod.prepare_data(waves, 75, ".txt", idtype, opts(order=2), out_dir=tmp_path / pkg)
    port, jax_side = _tables(tmp_path / "port"), _tables(tmp_path / "jax")
    assert Path("task.arpabo") in port and Path("test/utt2spk") in port
    assert port == jax_side


def test_corpus_synthesis_is_bit_equal(librispeech_corpus):
    (p_train, p_test, p_spk), (j_train, j_test, j_spk) = librispeech_corpus
    assert p_spk == j_spk and len(p_test) == 2
    for p, j in ((p_train, j_train), (p_test, j_test)):
        assert list(p) == list(j)
        for utt in p:
            assert p[utt][1] == j[utt][1]
            np.testing.assert_array_equal(p[utt][0], j[utt][0])
    assert port_testing.LEXICON == jax_testing.LEXICON


def test_prepare_dict_gives_the_same_lexicon_with_g2p(librispeech_corpus):
    (train, test, _), _ = librispeech_corpus
    vocab = sorted({w for _, ws in {**train, **test}.values() for w in ws} | set(G2P_WORDS))
    ref = {w: p for w, p in port_testing.LEXICON.items() if w not in G2P_WORDS}
    port_lex, g2p = port_dict.prepare_dict(vocab, ref, ["SIL"], "SIL", "<UNK>")
    jax_lex, _ = jax_dict.prepare_dict(vocab, ref, ["SIL"], "SIL", "<UNK>")
    assert g2p is not None and port_lex == jax_lex
    assert all(port_lex[w][0][1] != ("SIL",) for w in G2P_WORDS)


def test_prepare_dict_and_lang_writes_the_same_lang(librispeech_corpus, tmp_path):
    (train, test, utt2spk), _ = librispeech_corpus
    spoken = {w for _, ws in {**train, **test}.values() for w in ws}
    missing = sorted(spoken)[:3]
    waves = tmp_path / "waves"
    write_corpus(waves, train, test, utt2spk)
    ref_dict = tmp_path / "ref_dict.txt"
    ref_dict.write_text("".join(f"{w} {' '.join(p[0][1])}\n" for w, p in
                                sorted(port_testing.LEXICON.items()) if w not in missing))
    for name, cls, kw in (("port", Project, {"device": "cpu"}), ("jax", JaxProject, {})):
        proj = cls(tmp_path / name, waves_dir=waves, ref_dict=ref_dict, **kw)
        proj.prepare_data(percentage_train=67, order_ngram=3, idtype=0)
        proj.prepare_dict_and_lang()
        assert all(w in proj.lang.words for w in missing)
    port, jax_side = _tables(tmp_path / "port" / "lang"), _tables(tmp_path / "jax" / "lang")
    assert port and port == jax_side


def test_make_features_matches_jax(jax_project, yesno_waves, tmp_path):
    import voicebridge_tpu_torch.config as cfg

    proj = Project(tmp_path, waves_dir=yesno_waves, device="cpu")
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=1)
    proj.make_features(_mfcc(cfg))
    for split in ("train", "test"):
        got, want = ArrayArchive(tmp_path / "feats" / split), JaxArchive(
            jax_project[0].root / "feats" / split)
        assert got.keys() == want.keys()
        for u in want.keys():
            assert got[u].dtype == np.float32
            np.testing.assert_allclose(got[u], want[u], **FEATS_TOL)
            np.testing.assert_array_equal(proj.feats(split)[u].numpy(), got[u])


def test_decode_of_a_jax_project_matches(jax_project, port_on_jax_dir):
    _, _, want, _ = jax_project
    proj, _, got = port_on_jax_dir
    assert (got.best_lmwt, got.best_wip) == (want.best_lmwt, want.best_wip)
    assert vars(got.best_wer) == vars(want.best_wer) and got.best_wer.wer <= 10.0
    assert sorted(got.table) == sorted(want.table)
    assert all(vars(got.table[k]) == vars(want.table[k]) for k in want.table)


@pytest.mark.parametrize("name", ["transcription.txt", "ctm", "wer_table.txt",
                                  "per_utt_details.txt", "lattice_depth.txt"])
def test_decode_artifacts_of_a_jax_project_match(jax_project, port_on_jax_dir, name):
    got = port_on_jax_dir[0].exp_dir / "mono" / "decode" / name
    want = jax_project[0].exp_dir / "mono" / "decode" / name
    assert got.stat().st_size > 0
    assert filecmp.cmp(got, want, shallow=False), (got.read_text(), want.read_text())


def test_align_of_a_jax_project_matches(jax_project, port_on_jax_dir):
    _, jax_mono, _, want = jax_project
    proj, mono, _ = port_on_jax_dir
    got = proj.align(mono)
    assert got == want and len(got) == len(proj.train_data.utts)
    text = report_alignment_diagnostics(got, mono.trans_model, proj.lang, top=30)
    assert "utts" in text and "SIL" in text
    assert text == jax_diagnostics(want, jax_mono.trans_model, jax_project[0].lang, top=30)


def test_project_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Project(tmp_path / "p")
    assert not (tmp_path / "p").exists()


def test_yesno_example_reaches_the_wer_gate(yesno_example):
    work, res = yesno_example
    assert res.best_wer.wer <= 10.0
    assert (work / "exp" / "mono" / "final.am.npz").exists()


def test_reloaded_port_model_gives_the_same_result(yesno_example):
    import voicebridge_tpu_torch.config as cfg

    work, res = yesno_example
    proj = Project(work, waves_dir=work / "waves", device="cpu")
    proj.make_features(_mfcc(cfg))
    mono = proj.load_model("mono")
    again = proj.decode(mono, proj.mkgraph(mono, "mono"), opts=DecodeOptions(beam=1e9))
    assert vars(again.best_wer) == vars(res.best_wer)
    assert (again.best_lmwt, again.best_wip) == (res.best_lmwt, res.best_wip)


def test_train_mono_skips_when_cached(yesno_example):
    import voicebridge_tpu_torch.config as cfg

    work, _ = yesno_example
    proj = Project(work, waves_dir=work / "waves", device="cpu")
    proj.make_features(_mfcc(cfg))
    t0 = time.time()
    model = proj.train_mono(MonoTrainOptions(), name="mono")  # loads, does not retrain
    assert time.time() - t0 < 5.0
    assert model.am.num_gauss == proj.load_model("mono").am.num_gauss

"""The port's fMLLR and SAT (``transforms/fmllr.py``, ``steps/train_sat.py``,
``steps/decode_fmllr.py``) against the JAX package's on the same inputs, on
the CPU.

Tolerances: the fMLLR statistics are fp32 products summed in another order
and grouping (the port: blocks of 256 rows, float64 partial sums; the JAX
package: one product per 16k-row chunk), so beta, K and G are held at rtol
1e-4 with an atol of 1e-6 times each one's largest entry.  The per-speaker
transform is a row-by-row solve that amplifies such differences where a
speaker has few frames (8 test utterances of 4 speakers: about 260 frames
for 1640 parameters): from statistics that agree to 4e-6 its entries move
by up to 0.5 % of the largest, so transforms of one decode are held at an
atol of 1e-2 times the largest entry and their objective improvements at
rtol 1e-4.  ``apply_fmllr_batch`` is one fp32 product (rtol 1e-6, atol
1e-5).  Posteriors of one lattice are identical.  Decoded words are equal,
scores within rtol 1e-4.  End to end, the port's SAT training meets the JAX
test's WER gate (10 %) and moves the transforms off the identity by more
than 0.01.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicebridge_tpu.models.gmm import AmDiagGmm as JaxAm
from voicebridge_tpu.ops import gmm_kernels as JK
from voicebridge_tpu.transforms import fmllr as JF

from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.config import (FmllrDecodeOptions, FrameOptions, LangOptions,
                                          MfccOptions, TriTrainOptions)
from voicebridge_tpu_torch.data.lang import prepare_lang
from voicebridge_tpu_torch.fst.hclg import mkgraph
from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
from voicebridge_tpu_torch.lm.ngram import estimate_ngram
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.steps import decode_fmllr as DF
from voicebridge_tpu_torch.steps import train_sat as TS
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.steps.score import compute_wer_set
from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats
from voicebridge_tpu_torch.testing import load_synth_sat
from voicebridge_tpu_torch.transforms import fmllr as F

from synth import LEXICON, SR, make_speaker_corpus

torch.set_num_threads(2)
SAT_OPTS = dict(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                realign_iters=(2, 4, 6), mllt_iters=(2, 4), fmllr_iters=(2, 4, 6))
FMLLR_DECODE = dict(beam=1e9, first_beam=1e9, fmllr_min_count=50.0)


def _fmllr_inputs():
    """A GMM of 1-7 Gaussians a pdf, 6000 rows with zero weights, and three
    speakers, the third with about 150 weighted rows (below min_count 500)."""
    rng = np.random.default_rng(5)
    p, m, d, n = 30, 7, 13, 6000
    weights = np.zeros((p, m), np.float32)
    for i, k in enumerate(rng.integers(1, m + 1, p)):
        weights[i, :k] = rng.dirichlet(np.ones(k))
    means = rng.standard_normal((p, m, d)).astype(np.float32)
    iv = rng.uniform(0.5, 2.0, (p, m, d)).astype(np.float32)
    ids = rng.integers(0, p, n).astype(np.int32)
    x = (means[ids, 0] + rng.standard_normal((n, d))).astype(np.float32)
    w = rng.choice([0.0, 0.3, 1.0], size=n, p=[0.25, 0.25, 0.5]).astype(np.float32)
    spk = rng.choice([0, 1, 2], size=n, p=[0.5, 0.45, 0.05]).astype(np.int32)
    return JaxAm((means * iv).astype(np.float32), iv, weights), x, ids, w, spk


def _assert_stats_close(got, want):
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt, np.float64)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-6 * np.abs(wnt).max())


@pytest.mark.parametrize("dim,warp", [(13, 0.05), (40, 0.3), (40, 1.5)])
def test_native_row_update_is_the_numpy_solve(dim, warp):
    """``estimate_fmllr_rows`` (the sweeps in native code, A's inverse and
    determinant carried through a sweep by Sherman-Morrison) gives
    ``estimate_fmllr_batch``'s transforms and improvements to rounding: both
    solve in float64 (transforms atol 1e-6, improvements rtol 1e-9), from
    speakers near and far from the identity; a speaker below ``min_count``
    and a batch of none keep the identity."""
    rng = np.random.default_rng(dim)
    s, n = 4, 3000
    x = np.concatenate([rng.standard_normal((s, n, dim)), np.ones((s, n, 1))], axis=2)
    scale = rng.uniform(0.5, 2.0, (s, dim, 1, 1))
    g = np.einsum("snf,sne->sfe", x, x)[:, None] * scale
    w0 = np.concatenate([np.eye(dim) + warp * rng.standard_normal((s, dim, dim)) / np.sqrt(dim),
                         rng.standard_normal((s, dim, 1))], axis=2)
    k = np.einsum("sdj,sdij->sdi", w0, g)
    beta = np.asarray([n, n, 100.0, n])
    got, got_imprs = F.estimate_fmllr_rows(beta, k, g)
    want, want_imprs = F.estimate_fmllr_batch(beta, k, g)
    assert got.dtype == np.float32 and got.shape == (s, dim, dim + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_imprs, want_imprs, rtol=1e-9)
    np.testing.assert_array_equal(got[2], np.eye(dim, dim + 1, dtype=np.float32))
    assert got_imprs[2] == 0.0 and min(got_imprs[:2]) > 0
    assert np.abs(got[0, :, :dim] - np.eye(dim)).max() > 0.01
    none, none_imprs = F.estimate_fmllr_rows(beta[:0], k[:0], g[:0])
    assert none.shape == (0, dim, dim + 1) and none_imprs == []


@pytest.mark.parametrize("chunk", [None, 512])  # one chunk; chunks summed in float64
def test_acc_fmllr_stats_matches_jax(chunk):
    jam, x, ids, w, spk = _fmllr_inputs()
    want = JF.acc_fmllr_stats(JK.pack_gmm(jam), jnp.asarray(jam.means()),
                              jnp.asarray(jam.inv_vars), x, ids, w, spk, 3)
    am = convert.am_from_arrays(jam.means_invvars, jam.inv_vars, jam.weights)
    got = F.acc_fmllr_stats(K.pack_gmm(am, "cpu"), am.means(), am.inv_vars, x, ids, w, spk, 3,
                            chunk=chunk, device="cpu")
    assert [tuple(g.shape) for g in got] == [(3,), (3, 13, 14), (3, 13, 14, 14)]
    assert all(g.dtype == torch.float32 for g in got)
    _assert_stats_close(got, want)
    trans, imprs = F.estimate_fmllr_batch(*[g.numpy() for g in got])
    want_trans, want_imprs = JF.estimate_fmllr_batch(*[np.asarray(a) for a in want])
    assert imprs[2] == 0.0 and want_imprs[2] == 0.0  # below min_count: the identity
    np.testing.assert_array_equal(trans[2], np.eye(13, 14, dtype=np.float32))
    np.testing.assert_allclose(trans, want_trans, rtol=0, atol=1e-4)
    np.testing.assert_allclose(imprs, want_imprs, rtol=1e-4)


def test_acc_fmllr_stats_leaves_out_unused_rows():
    """Rows of weight 0 and rows of a speaker outside the range add nothing:
    the statistics equal those of the other rows alone (to the last bit,
    the same blocks in the same order)."""
    jam, x, ids, w, spk = _fmllr_inputs()
    am = convert.am_from_arrays(jam.means_invvars, jam.inv_vars, jam.weights)
    params = K.pack_gmm(am, "cpu")
    spk = spk.copy()
    spk[:40] = [5, -1] * 20
    used = (w != 0) & (spk >= 0) & (spk < 3)
    got = F.acc_fmllr_stats(params, am.means(), am.inv_vars, x, ids, w, spk, 3, device="cpu")
    want = F.acc_fmllr_stats(params, am.means(), am.inv_vars, x[used], ids[used], w[used],
                             spk[used], 3, device="cpu")
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)


def test_apply_fmllr_batch_matches_jax():
    rng = np.random.default_rng(6)
    x = (3 * rng.standard_normal((5, 40, 13))).astype(np.float32)
    eye = np.concatenate([np.eye(13), np.zeros((13, 1))], axis=1)
    trans = (eye + 0.2 * rng.standard_normal((3, 13, 14))).astype(np.float32)
    spk = np.array([2, 0, 1, 2, 0])
    want = np.asarray(JF.apply_fmllr_batch(jnp.asarray(x), trans, spk))
    got = F.apply_fmllr_batch(torch.from_numpy(x), trans, spk, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def sat_fixture():
    """The JAX-trained SAT fixture and its 8 test utterances' LDA features,
    made by the port on the CPU."""
    m = load_synth_sat()
    train, test, utt2spk = make_speaker_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    waves = {u: w for u, (w, _) in {**train, **test}.items()}
    base = make_features(waves, utt2spk, opts, deltas=None, device="cpu")
    feats = lda_decode_feats({u: base[u] for u in test}, m.final_mat, device="cpu")
    utts = sorted(feats)
    x, nf = pad_features(feats, utts)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    return dict(m=m, utt2spk=utt2spk, utts=utts, x=x, nf=nf, lang=lang, test=test)


def test_jax_trained_sat_decodes_to_the_jax_words(sat_fixture):
    """The committed JAX-trained SAT model through the port's
    ``decode_fmllr`` on the port's features: the JAX package's words for
    every test utterance, scores within rtol 1e-4, final transforms within
    an atol of 1e-2 times their largest entry."""
    s = sat_fixture
    m = s["m"]
    stages = {}
    res, trans = DF.decode_fmllr(m.hclg, m.trans_model, m.am, m.alimdl, s["lang"], s["utts"],
                                 s["x"], s["nf"], s["utt2spk"],
                                 FmllrDecodeOptions(**FMLLR_DECODE), device="cpu",
                                 stage_s=stages)
    assert [r.utt for r in res] == s["utts"]
    assert {r.utt: [m.words.sym(w) for w in r.words] for r in res} == m.hyps
    np.testing.assert_allclose([r.score for r in res], [m.scores[u] for u in s["utts"]],
                               rtol=1e-4)
    speakers, want = convert.transforms_from_dict(m.transforms)
    assert speakers == sorted({s["utt2spk"][u] for u in s["utts"]})
    assert trans.shape == want.shape == (4, 40, 41)
    np.testing.assert_allclose(trans, want, rtol=0, atol=1e-2 * np.abs(want).max())
    assert list(stages) == ["si_lattices", "first_transforms", "adapted_lattices",
                            "second_transforms", "rescore", "determinize"]


def _jax_lattice_posteriors(lats, utts, trans_model, sil_set, t_max, opts):
    """``voicebridge_tpu/steps/decode_fmllr.py``'s per-frame loop
    (``lattice_posteriors`` inside ``decode_fmllr``) over the JAX package's
    ``lattice_to_post``, as written there."""
    from voicebridge_tpu.lat import lattice_to_post as jax_lattice_to_post

    k_post = DF.K_POST
    pdf = np.zeros((len(utts), t_max, k_post), np.int32)
    w = np.zeros((len(utts), t_max, k_post), np.float32)
    for i, u in enumerate(utts):
        lat = lats[u]
        if lat.num_arcs == 0:
            continue
        _ap, per_frame = jax_lattice_to_post(lat, acoustic_scale=opts.acoustic_scale,
                                             min_post=0.01)
        for t, entries in enumerate(per_frame):
            entries = sorted(entries, key=lambda e: -e[2])[:k_post]
            for kk, (tid, pdfk, p) in enumerate(entries):
                sil = int(trans_model.tid2phone[tid]) in sil_set
                pdf[i, t, kk] = pdfk
                w[i, t, kk] = p * (opts.silence_weight if sil else 1.0)
    return pdf.reshape(-1), w.reshape(-1)


def test_lattice_posteriors_match_jax(sat_fixture):
    """On the fixture's SI lattices (plus a copy of one whose arcs all tie,
    so every frame ranks ties), the port's vectorized top-K posteriors are
    the JAX package's loop's, to the last bit."""
    s = sat_fixture
    m = s["m"]
    opts = FmllrDecodeOptions(**FMLLR_DECODE)
    dec = Decoder(m.hclg, m.trans_model, m.alimdl, DF._decode_opts(opts, first=True),
                  device="cpu")
    lats = dec.decode_lattice(s["utts"], s["x"], s["nf"])
    first = lats[s["utts"][0]]
    lats[s["utts"][0]] = replace(first, acoustic_cost=np.zeros_like(first.acoustic_cost),
                                 _states={})
    sil = set(s["lang"].silence_phone_ids)
    t_max = s["x"].shape[1]
    got = DF.lattice_posteriors(lats, s["utts"], m.trans_model.tid2phone, sil, t_max,
                                opts.acoustic_scale, opts.silence_weight)
    want = _jax_lattice_posteriors(lats, s["utts"], m.trans_model, sil, t_max, opts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[1] > 0).sum() > len(s["utts"]) * 50


def test_survivor_index_does_not_wrap():
    """Stage 4 past 2^31: 64 utterances x 20,000 frames x 2^21 pdfs (the
    JAX package's int32 flat index ``(j*T + t)*P + pdf`` wraps there).  The
    port's index arrays are int64 and unflattened, and its gather reads the
    right entries of a loglik block that is never allocated (an expanded
    view whose value at (j, t, pdf) is pdf)."""
    from voicebridge_tpu_torch.lat import Lattice

    b, t_max, num_pdfs = 64, 20_000, 1 << 21
    assert b * t_max * num_pdfs > 2 ** 31
    arc_pdf = np.array([0, 17, num_pdfs - 1, num_pdfs - 2], np.int32)
    lats = [Lattice(graph=None, nf=t_max, arc_t=np.array(t, np.int32),
                    arc_id=np.array(a, np.int32), acoustic_cost=np.zeros(len(a), np.float32),
                    use_final=True)
            for t, a in (([0, 5], [1, 2]), ([], []), ([t_max - 1, t_max - 1, 3], [2, 3, 0]))]
    lats += [replace(lats[2]) for _ in range(b - 3)]
    j, t, pdf = DF.survivor_index(lats, arc_pdf)
    assert j.dtype == t.dtype == pdf.dtype == np.int64
    assert j[-1] == b - 1 and t[-1] == 3 and pdf[-3] == num_pdfs - 1
    flat = (j * t_max + t) * num_pdfs + pdf
    assert flat.max() > 2 ** 31 and (flat.astype(np.int32) != flat).any()
    ll = (-torch.arange(num_pdfs, dtype=torch.float32))[None, None].expand(b, t_max, num_pdfs)
    np.testing.assert_array_equal(DF.gather_costs(ll, j, t, pdf), pdf.astype(np.float32))


@pytest.fixture(scope="module")
def jax_sat_inputs():
    """The JAX package's delta and LDA features of the speaker corpus, its
    monophone model and alignments (delta), and its tri2b model, final
    matrix and alignments (LDA): the recipe of ``tests/test_sat_lda.py``."""
    from voicebridge_tpu.config import FrameOptions as JFO, LangOptions as JLO
    from voicebridge_tpu.config import MfccOptions as JMO, MonoTrainOptions as JMono
    from voicebridge_tpu.config import TriTrainOptions as JTri
    from voicebridge_tpu.data.lang import prepare_lang as jprepare_lang
    from voicebridge_tpu.steps.align import align_utterances as jalign
    from voicebridge_tpu.steps.make_feats import (apply_feature_chain, compute_cmvn,
                                                  compute_mfcc)
    from voicebridge_tpu.steps.train_lda_mllt import (lda_decode_feats as jlda_feats,
                                                      train_lda_mllt as jtrain_lda_mllt)
    from voicebridge_tpu.steps.train_mono import train_mono as jtrain_mono

    train, test, utt2spk = make_speaker_corpus(num_speakers=4, utts_per_speaker=6,
                                               num_test_per=2, seed=3)
    waves = {u: w for u, (w, _) in {**train, **test}.items()}
    mfcc = compute_mfcc(waves, JMO(frame_opts=JFO(samp_freq=SR, dither=0.0)))
    cmvn = compute_cmvn(mfcc, utt2spk)
    base = apply_feature_chain(mfcc, utt2spk, cmvn, deltas=None)
    delta = apply_feature_chain(mfcc, utt2spk, cmvn)
    jlang = jprepare_lang(LEXICON, ["SIL"], "SIL", JLO())
    transcripts = {u: [jlang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    tr_delta = {u: delta[u] for u in train}
    mono = jtrain_mono(tr_delta, transcripts, jlang,
                       JMono(num_iters=10, totgauss=150, max_iter_inc=8,
                             realign_iters=tuple(range(1, 10))))
    ali = jalign(mono.am, mono.trans_model, jlang, tr_delta, transcripts, acoustic_scale=0.1)
    base_train = {u: base[u] for u in train}
    tri2b, final_mat = jtrain_lda_mllt(base_train, transcripts, ali, jlang, JTri(**SAT_OPTS),
                                       prev_trans_model=mono.trans_model)
    lda = jlda_feats({**base_train, **{u: base[u] for u in test}}, final_mat)
    ali2 = jalign(tri2b.am, tri2b.trans_model, jlang, {u: lda[u] for u in train},
                  transcripts, acoustic_scale=0.1)
    return dict(train=train, test=test, utt2spk=utt2spk, transcripts=transcripts,
                jlang=jlang, variants={"delta": (delta, mono, ali), "lda": (lda, tri2b, ali2)})


@pytest.mark.parametrize("variant", ["delta", "lda"])
def test_train_sat_matches_jax(jax_sat_inputs, variant, tmp_path, monkeypatch):
    """``train_sat`` from the JAX package's features, previous model and
    alignments (delta: the monophone system, ``test_sat_fmllr_end_to_end``;
    LDA: tri2b, ``test_lda_mllt_sat_end_to_end``): the initial transforms
    and the tree equal the JAX package's (its ``train_sat`` run to 0
    iterations, carried over by ``convert.sat_model_from_arrays``); after 8
    iterations the port's ``decode_fmllr`` on the test utterances meets the
    JAX test's gates: WER <= 10 %, transforms off the identity by > 0.01."""
    from voicebridge_tpu.config import TriTrainOptions as JTri
    from voicebridge_tpu.steps.train_sat import train_sat as jtrain_sat

    from test_torch_tri import _port_tm, _tree_arrays

    j = jax_sat_inputs
    feats, prev, ali = j["variants"][variant]
    train_feats = {u: feats[u] for u in j["train"]}
    jsat = jtrain_sat(train_feats, j["utt2spk"], j["transcripts"], ali, prev.am, j["jlang"],
                      JTri(**{**SAT_OPTS, "num_iters": 0}), prev_trans_model=prev.trans_model)
    jtm = jsat.model.trans_model
    for obj, name in ((jtm.topo, "topo"), (jtm.tree, "tree"), (jtm, "trans")):
        obj.save(tmp_path / f"jax_{name}.json")
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    want = convert.sat_model_from_arrays(
        (jsat.model.am.means_invvars, jsat.model.am.inv_vars, jsat.model.am.weights),
        (jsat.alimdl.means_invvars, jsat.alimdl.inv_vars, jsat.alimdl.weights),
        *[json.loads((tmp_path / f"jax_{n}.json").read_text()) for n in ("topo", "tree", "trans")],
        lang, jsat.transforms)
    initial = []

    def recorded(*args, **kwargs):
        out = estimate(*args, **kwargs)
        initial.append(out)
        return out

    estimate = TS.estimate_transforms
    monkeypatch.setattr(TS, "estimate_transforms", recorded)
    prev_am = convert.am_from_arrays(prev.am.means_invvars, prev.am.inv_vars, prev.am.weights)
    sat = TS.train_sat(train_feats, j["utt2spk"], j["transcripts"], ali, prev_am, lang,
                       TriTrainOptions(**SAT_OPTS),
                       prev_trans_model=_port_tm(prev.trans_model, tmp_path),
                       out_dir=tmp_path / "port", device="cpu")
    assert len(initial) == 1 + len(SAT_OPTS["fmllr_iters"])
    speakers, want_trans = convert.transforms_from_dict(want.transforms)
    assert speakers == sorted(sat.transforms)
    np.testing.assert_allclose(initial[0][0], want_trans, rtol=0,
                               atol=1e-3 * np.abs(want_trans).max())
    assert all(i > 0 for i in initial[0][1])
    assert _tree_arrays(sat.model.tree) == _tree_arrays(want.model.tree)
    assert (tmp_path / "port" / "final.alimdl.npz").exists()

    utts = sorted(j["test"])
    g = arpa_to_fst(estimate_ngram([ws for (_w, ws) in j["train"].values()], order=2),
                    lang.words.id, lang.word_disambig_id)
    model = sat.model
    x = np.zeros((len(utts), max(feats[u].shape[0] for u in utts), feats[utts[0]].shape[1]),
                 np.float32)
    for i, u in enumerate(utts):
        x[i, : feats[u].shape[0]] = feats[u]
    res, trans = DF.decode_fmllr(mkgraph(lang, model.tree, model.trans_model, g),
                                 model.trans_model, model.am, sat.alimdl, lang, utts, x,
                                 np.array([feats[u].shape[0] for u in utts]), j["utt2spk"],
                                 FmllrDecodeOptions(**FMLLR_DECODE), device="cpu")
    stats = compute_wer_set({u: list(j["test"][u][1]) for u in utts},
                            {r.utt: [lang.words.sym(w) for w in r.words] for r in res})
    print(f"port {variant}+sat end-to-end:", stats)
    assert stats.wer <= 10.0
    d = x.shape[2]
    assert np.abs(trans[:, :, :d] - np.eye(d)[None]).max() > 0.01


@pytest.mark.parametrize("entry", ["train_sat", "decode_fmllr", "acc_fmllr_stats",
                                   "apply_fmllr_batch"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without ``device``, the new entry points run on ``cuda:0``:
    where CUDA is not available they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = {"u": torch.zeros((5, 13))}
    x = np.zeros((1, 5, 13), np.float32)
    am = convert.am_from_arrays(np.zeros((2, 1, 13)), np.ones((2, 1, 13)), np.ones((2, 1)))
    calls = {
        "train_sat": lambda: TS.train_sat(feats, {"u": "s"}, {}, {}, am, None,
                                          prev_trans_model=object()),
        "decode_fmllr": lambda: DF.decode_fmllr(None, None, am, am, None, ["u"], x, [5],
                                                {"u": "s"}),
        "acc_fmllr_stats": lambda: F.acc_fmllr_stats(K.pack_gmm(am, "cpu"), am.means(),
                                                     am.inv_vars, x[0], np.zeros(5, int),
                                                     np.ones(5), np.zeros(5, int), 1),
        "apply_fmllr_batch": lambda: F.apply_fmllr_batch(x, np.zeros((1, 13, 14)), [0])}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()

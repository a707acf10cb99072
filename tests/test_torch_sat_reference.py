"""``FmllrDecoder`` (``steps/decode_fmllr.py``) held stage by stage to the
plain float64 reference of the benchmark (``benchmarks/vbbench/reference/
fmllr.py``, which imports nothing of the port) on the CPU, each stage fed
the decoder's own inputs to it: 2 speakers x 4 utterances x 200 frames of
40-dim features drawn along paths of a 2,000-state graph with words, 60
pdfs x 300 Gaussians; one decoder over three calls against three calls of
``decode_fmllr``; the determinizations on one thread and on many."""

import contextlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.config import FmllrDecodeOptions
from voicebridge_tpu_torch.ops.graph import NEG_INF, DenseGraph
from voicebridge_tpu_torch.steps import decode_fmllr as DF

_REF = Path(__file__).resolve().parents[1] / "benchmarks" / "vbbench" / "reference" / "fmllr.py"
_spec = importlib.util.spec_from_file_location("sat_decode_reference", _REF)
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)

SPEAKERS, UTTS, FRAMES, DIM = 2, 4, 200, 40
PDFS, MIX, STATES = 60, 5, 2000
OPTS = FmllrDecodeOptions(fmllr_min_count=100.0)


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread inside: the plain lattice passes are many
    small ops, which spin on a shared host when every test process runs a
    thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _graph(rng):
    """An HCLG-shaped graph (a self-loop and 7 arcs 1-15 states ahead a
    state, all arcs into a state sharing its pdf), a state starting one of
    100 words with probability 1/15 (output on the arcs into it from other
    states); transition id ``1 + 2 pdf + (0 self-loop | 1 forward)``."""
    src = np.repeat(np.arange(STATES), 8)
    jump = rng.integers(1, 16, len(src))
    jump[::8] = 0
    dst = (src + jump) % STATES
    state_pdf = rng.integers(0, PDFS, STATES)
    word = np.where(rng.random(STATES) < 1 / 15, rng.integers(1, 101, STATES), 0)
    self_loop = jump == 0
    arc_word = np.where(self_loop, 0, word[dst])
    alpha0 = np.full(STATES, -np.inf)
    alpha0[0] = 0.0
    g = {"src": src, "dst": dst, "pdf": state_pdf[dst], "word": arc_word,
         "score": -rng.exponential(1.0, len(src)).astype(np.float32), "alpha0": alpha0,
         "final": np.zeros(STATES), "tid": 1 + 2 * state_pdf[dst] + (~self_loop)}
    vocab = np.unique(arc_word)
    dense = DenseGraph(
        num_states=STATES, arc_src=src.astype(np.int32), arc_dst=dst.astype(np.int32),
        arc_tid=g["tid"].astype(np.int32), arc_pdf=g["pdf"].astype(np.int32),
        arc_score=g["score"], arc_oseq=np.searchsorted(vocab, arc_word).astype(np.int32),
        alpha0=np.where(np.isfinite(alpha0), alpha0, NEG_INF).astype(np.float32),
        start_oseq=np.zeros(STATES, np.int32), final_score=np.zeros(STATES, np.float32),
        final_oseq=np.zeros(STATES, np.int32), oseqs=[()] + [(int(w),) for w in vocab[1:]])
    return g, dense


def _gmm_dict(am) -> dict:
    """The float64 values of a float32 model (the reference's arrays)."""
    iv = am.inv_vars.astype(np.float64)
    return {"means": am.means_invvars.astype(np.float64) / iv, "vars": 1.0 / iv,
            "weights": am.weights.astype(np.float64)}


def sat_inputs(seed: int = 22) -> SimpleNamespace:
    """The case's graph (``g`` the reference's arrays, ``dense`` the
    port's), models (``am``, ``alimdl``), features ``[8, 200, 40]`` drawn
    along random walks of the graph under ``am`` and warped per speaker,
    and the decoder's other inputs."""
    rng = np.random.default_rng(seed)
    g, dense = _graph(rng)
    means = rng.standard_normal((PDFS, MIX, DIM))
    var = rng.uniform(0.5, 2.0, (PDFS, MIX, DIM)) / 30.0
    am = convert.am_from_arrays(means / var, 1.0 / var, np.full((PDFS, MIX), 1.0 / MIX))
    ali_means = means + 0.05 * rng.standard_normal(means.shape)
    ali_var = var * rng.uniform(0.9, 1.1, var.shape)
    alimdl = convert.am_from_arrays(ali_means / ali_var, 1.0 / ali_var,
                                    np.full((PDFS, MIX), 1.0 / MIX))
    b = SPEAKERS * UTTS
    state = np.zeros(b, np.int64)
    clean = np.zeros((b, FRAMES, DIM))
    for t in range(FRAMES):
        arc = 8 * state + np.where(rng.random(b) < 0.5, 0, rng.integers(1, 8, b))
        state = g["dst"][arc]
        pdf, k = g["pdf"][arc], rng.integers(0, MIX, b)
        clean[:, t] = means[pdf, k] + np.sqrt(var[pdf, k]) * rng.standard_normal((b, DIM))
    eye = np.concatenate([np.eye(DIM), np.zeros((DIM, 1))], 1)
    warp = eye + 0.03 * rng.standard_normal((SPEAKERS, DIM, DIM + 1))
    spk = np.arange(b) // UTTS
    feats = (np.einsum("bde,bte->btd", warp[spk][:, :, :DIM], clean)
             + warp[spk][:, None, :, DIM]).astype(np.float32)
    utts = [f"s{s}_u{i}" for s in range(SPEAKERS) for i in range(UTTS)]
    tid2phone = np.concatenate([[0], 1 + np.repeat(np.arange(PDFS), 2) % 10])
    return SimpleNamespace(g=g, dense=dense, am=am, alimdl=alimdl, feats=feats,
                           nf=np.full(b, FRAMES), utts=utts, utt2spk={u: u[:2] for u in utts},
                           tm=SimpleNamespace(tid2phone=tid2phone),
                           lang=SimpleNamespace(silence_phone_ids=[1]), spk=spk,
                           silence_arc=tid2phone[g["tid"]] == 1)


@pytest.fixture(scope="module")
def case():
    c = sat_inputs()
    c.dec = DF.FmllrDecoder(c.dense, c.tm, c.am, c.alimdl, c.lang, OPTS, device="cpu")
    c.keep = {}
    c.results, c.trans = c.dec.decode(c.utts, c.feats, c.nf, c.utt2spk, keep=c.keep)
    c.final64, c.alimdl64 = _gmm_dict(c.am), _gmm_dict(c.alimdl)
    return c


def _lattice(lat):
    return (lat.arc_t, lat.arc_id, lat.acoustic_cost)


def _ll64(gmm, x):
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    return REF.loglikes(gmm, x.reshape(-1, DIM)).view(x.shape[0], x.shape[1], -1)


@pytest.mark.parametrize("stage", ["si_lattices", "adapted_lattices"])
def test_lattice_passes_match_the_plain_forward_backward(case, stage):
    """Each pass's survivors are the float64 forward-backward's on the
    pass's own features, but for arcs within 2e-3 of the beam's edge (the
    plain K3/K5 sum float32 scores of about 1e3 over 200 frames); their
    costs are -loglik64 within 1e-2 (float32 products of terms near 1e4)."""
    model, x = ((case.alimdl64, case.feats) if stage == "si_lattices"
                else (case.final64, case.keep["adapted1"]))
    ll = _ll64(model, x)
    lats = [case.keep[stage][u] for u in case.utts]
    pdf = torch.as_tensor(case.g["pdf"])
    for i, lat in enumerate(lats):
        want = -ll[i, torch.as_tensor(lat.arc_t).long(), pdf[torch.as_tensor(lat.arc_id).long()]]
        np.testing.assert_allclose(lat.acoustic_cost, want.numpy(), rtol=0, atol=1e-2)
    got = {(i, int(t), int(a)) for i, lat in enumerate(lats)
           for t, a in zip(lat.arc_t, lat.arc_id)}
    worst = [0.0]

    def visit(t, margin):
        for i in range(margin.shape[0]):
            sure = torch.nonzero(margin[i] >= 2e-3).squeeze(1).tolist()
            assert all((i, t, a) in got for a in sure)
        for i, tt, a in got:
            if tt == t:
                worst[0] = min(worst[0], float(margin[i, a]))

    REF.forward_backward(case.g, ll, OPTS.acoustic_scale, OPTS.lattice_beam, visit)
    assert worst[0] > -2e-3
    depth = np.mean([lat.num_arcs / lat.nf for lat in lats])
    assert 1.0 <= depth < 200  # lattices, not single paths or the whole graph


@pytest.mark.parametrize("stage", [("si_lattices", "transforms1", "adapted1"),
                                   ("adapted_lattices", "transforms2", "adapted2")])
def test_transforms_match_the_row_by_row_update(case, stage):
    """The reference's transform of each speaker from the decoder's lattices
    (their posteriors, the float64 statistics on the base features, the row
    solve) within 2e-3 of the decoder's (its statistics reach the solve as
    float32, as the JAX package hands them), and the features it gives
    within 2e-3 of the decoder's (features of about 3 in size)."""
    lats_key, trans_key, feats_key = stage
    for s in range(SPEAKERS):
        rows = np.flatnonzero(case.spk == s)
        lats = [_lattice(case.keep[lats_key][case.utts[i]]) for i in rows]
        base = torch.as_tensor(case.feats[rows], dtype=torch.float64)
        pdf, w = REF.lattice_posteriors(case.g, lats, FRAMES, OPTS.acoustic_scale,
                                        case.silence_arc, OPTS.silence_weight)
        beta, k, g = REF.fmllr_stats(case.final64, base.reshape(-1, DIM),
                                     pdf.reshape(-1, DF.K_POST), w.reshape(-1, DF.K_POST))
        assert float(beta) > OPTS.fmllr_min_count
        want = REF.fmllr_solve(float(beta), k, g, OPTS.fmllr_min_count)
        got = case.keep[trans_key][s]
        assert np.abs(got[:, :DIM] - np.eye(DIM)).max() > 1e-2  # the warp is undone
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2e-3)
        np.testing.assert_allclose(case.keep[feats_key][rows].numpy(),
                                   REF.apply_transform(want, base).numpy(), rtol=0, atol=2e-3)


def test_posteriors_match_the_plain_lattice_to_post(case):
    """The decoder's top-4 posteriors (pdf, silence-weighted weight) of the
    SI lattices are the float64 reference's within 2e-5 (the decoder adds
    each arc's graph and scaled acoustic cost in float32, as Kaldi's
    lattice weights are float, before its float64 sweeps)."""
    pdf, w = DF.lattice_posteriors(case.keep["si_lattices"], case.utts, case.tm.tid2phone,
                                   set(case.lang.silence_phone_ids), FRAMES,
                                   OPTS.acoustic_scale, OPTS.silence_weight)
    lats = [_lattice(case.keep["si_lattices"][u]) for u in case.utts]
    rpdf, rw = REF.lattice_posteriors(case.g, lats, FRAMES, OPTS.acoustic_scale,
                                      case.silence_arc, OPTS.silence_weight)
    live = rw.reshape(-1).numpy() > 0
    assert live.sum() > len(case.utts) * FRAMES
    np.testing.assert_array_equal(pdf[live], rpdf.reshape(-1).numpy()[live])
    np.testing.assert_allclose(w, rw.reshape(-1).numpy(), rtol=0, atol=2e-5)


def test_rescored_lattices_and_best_paths_match(case):
    """The rescored costs are -loglik64 of the final features within 1e-2;
    each determinized best path has the plain best path's words and its
    score within 1e-2 (float32 costs summed over words)."""
    ll = _ll64(case.final64, case.keep["adapted2"])
    pdf = torch.as_tensor(case.g["pdf"])
    said = 0
    for i, (u, r) in enumerate(zip(case.utts, case.results)):
        lat = case.keep["rescored"][u]
        want = -ll[i, torch.as_tensor(lat.arc_t).long(), pdf[torch.as_tensor(lat.arc_id).long()]]
        np.testing.assert_allclose(lat.acoustic_cost, want.numpy(), rtol=0, atol=1e-2)
        score, words = REF.best_path(case.g, _lattice(lat), FRAMES, OPTS.acoustic_scale)
        assert r.words == words
        assert abs(r.score - score) < 1e-2
        assert len(r.tids) == FRAMES
        said += len(words)
    assert said >= len(case.utts)


def test_one_decoder_over_three_calls_is_three_single_calls(case):
    """A decoder built once gives, call after call, the bits of a fresh
    ``decode_fmllr`` on each batch."""
    batches = [(case.utts[:UTTS], case.feats[:UTTS]), (case.utts[UTTS:], case.feats[UTTS:]),
               (case.utts[:UTTS], case.feats[:UTTS, ::-1].copy())]
    for utts, x in batches:
        got, gt = case.dec.decode(utts, x, case.nf[:len(utts)], case.utt2spk)
        want, wt = DF.decode_fmllr(case.dense, case.tm, case.am, case.alimdl, case.lang, utts, x,
                                   case.nf[:len(utts)], case.utt2spk, OPTS, device="cpu")
        assert [(r.utt, r.words, r.score, r.tids) for r in got] == \
            [(r.utt, r.words, r.score, r.tids) for r in want]
        np.testing.assert_array_equal(gt, wt)


def test_determinizations_on_many_threads_match_one(case, monkeypatch):
    """The determinizations spread over threads (the native calls release
    the GIL) give the results and counters of one thread."""
    from voicebridge_tpu_torch.utils import profiling

    got = []
    for threads in (1, 4):
        monkeypatch.setattr(DF, "host_threads", lambda n=threads: n)
        with profiling.recording():
            res = case.dec._determinize(case.utts, case.keep["rescored"])
        counts = profiling.session().counters
        got.append(([(r.utt, r.words, r.score, r.tids) for r in res],
                    counts["fmllr.det_states"], counts["fmllr.det_retries"]))
    assert got[0] == got[1]
    assert got[0][0] == [(r.utt, r.words, r.score, r.tids) for r in case.results]

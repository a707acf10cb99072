"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors, at small shapes and over the options ``chip_smoke.py`` does
not reach (for K1 every FFT size from 128 to 4096 points, power of two or
not, with fbank rows, energy and window options, the sparse mel bit-equal
to the dense one, and the refusal above 4096; for K2 ragged frame and pdf
counts on every edge of its tiles, 1 to 8 components, feature dims 11 to
80, the features' own scale from the Yes-No corpus and model, and its
ragged layout of live Gaussians on the benchmark's tri2b and tri5b mixtures
and the layout's edges; CMVN and
transition statistics bit-equal from run to run; for the Viterbi step K3 row widths 1 to 8 and 12, 1 to 130
lanes, uint8 and int16 backpointers, dead and bucket-padding rows, windows
of 1, 3 and T frames, a one-block grid and the lattice's backward window,
and the recompute decode; for the aligner K4
ragged and empty utterances, a failed utterance and a band matrix W too
large for shared memory, one frame, fewer frames than the emission ring
holds, lanes with no frames and more than 512 states; for the E-step K6 a
pdf holding most frames, zero-weight frames and two different feature
arrays, every frame on one pdf, fewer pdfs counted than the model has, fewer
frames than one chunk of the card's sort, pdfs with no frames and no frame
of nonzero weight, more chunks than the card's sort holds at once and 12,000
pdfs, the work list built on the card bit-equal to the plain one; for the lattice step K5
row widths 1 to 8, 1 to 130 lanes, ragged and empty utterances, utterances
that reach no final state, windows of 1, 3, 7, 16 and T frames and a
one-block grid, and the lattice decode against the CPU;
for the N-best step K7 list lengths 1 to 16, 1 to 33 lanes, windows of 1, 3
and T frames, a one-block grid, a finite beam, ragged and empty utterances,
and ``decode_nbest`` against the CPU; for the two backtraces 1 to 130 lanes,
1 to 1000 frames, uint8 and int16 codes, a state carried across blocks,
failed N-best walks and strided tables, for the N-best walk also a state of
more than 32 in-arcs, arcs its row does not hold and the tables K7 writes,
and for the best path row widths 1,
8 and 12, an empty block, a block starting inside the lanes' frames, a
state of more slots than a warp speculates on and row starts past 16 bits; for K4's backtrace failures
on the path, K = 1 and 12, S of 45, 700 and 120,000 (rows too wide to
stage), one lane and 130, and 2000 frames in 24 staged chunks; for the generic aligner
ragged and empty utterances, a finite beam, graphs whose arcs or whose alpha
outgrow the default shared memory, a best path through a back arc, rows of
6 and 15 arcs (past the registers' 4) and of 304 (past the byte codes),
19,301 states with about 3,970 distinct pdfs (the emissions read without the
ring, near the largest alpha the kernel takes), each through the old
signatures and through a plan, the staged walk meeting a missing arc
over 1 and 1000 frames, no host synchronisation given a plan, and
``max_active``, which its kernel refuses; for the fMLLR statistics D = 40
on uneven mixtures in one chunk and in chunks against float64, and two runs
bit-equal; ``apply_fmllr_batch`` against float64; ``decode_fmllr`` of the
JAX-trained SAT fixture to the JAX package's words; K1's ``mel_power`` mode
at 256, 400, 512 and 1024 points with HTK mode on and off, and PLP through
it, against float64; the PLP, fbank and spectrogram extractors and
``make_features(pitch=True)`` against the CPU; ``regtree_fmllr_loglikes``
through K2 with 1, 2 and 8 classes and a pdf with no active Gaussian;
``acc_regtree_mllr_stats`` through K6 and the regression-tree fMLLR
statistics; ``loglikes_full`` and ``acc_full_stats`` across chunk
boundaries against float64; for the lane-major lattice FB exact search, a
beam, ``max_active`` with ties (also across two lane groups), windows of 1
frame and longer than T, 130 lanes, states without in- or out-arcs and a
hub of about 5,000 arcs each way, one device kernel per window and pass).  They need an NVIDIA
GPU and nvcc, and skip without one:

    python -m pytest tests/test_torch_cuda.py -m cuda

Each case has ``CASE_TIMEOUT_S`` seconds: past that, faulthandler prints
every thread's stack and ends the run, so a stall on the card fails within
minutes and shows where it hung.
"""

import dataclasses
import faulthandler

import numpy as np
import pytest
import torch

from voicebridge_tpu_torch import _build
from voicebridge_tpu_torch.config import DecodeOptions, FrameOptions, MelOptions, MfccOptions
from voicebridge_tpu_torch.models.gmm import AmDiagGmm
from voicebridge_tpu_torch.ops import align_band as AB
from voicebridge_tpu_torch.ops import decode_core as DC
from voicebridge_tpu_torch.ops import features as TF
from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel, mfcc_kernel
from voicebridge_tpu_torch.ops import lattice as LAT
from voicebridge_tpu_torch.ops import viterbi as V
from voicebridge_tpu_torch.ops.graph import DenseGraph
from voicebridge_tpu_torch.steps.align import AlignmentSet, apply_alignments
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features
from voicebridge_tpu_torch.testing import (assert_models_close, feature_scaled_am,
                                           load_yesno_mono, random_am, random_band_walk,
                                           random_codes, synth_decode_graph, synth_hub_graph,
                                           synth_train_graph)
from voicebridge_tpu_torch.transforms import cmvn as TC
from voicebridge_tpu_torch.transforms import lda as TL
from voicebridge_tpu_torch.transforms import mllt as TM
from voicebridge_tpu_torch.utils import profiling as P

import k2_cases
from synth import make_corpus

pytestmark = pytest.mark.cuda
CASE_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def stall_guard():
    faulthandler.dump_traceback_later(CASE_TIMEOUT_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(sr, ws, n_frames, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(ws) / sr
    base = 3000 * np.sin(2 * np.pi * rng.uniform(100, 1500, (n_frames, 1)) * t)
    return (base + 80 * rng.standard_normal((n_frames, ws))).astype(np.float32)


# K1 sizes: (sample rate, frame length in ms, round to a power of two) ->
# padded window of 128, 200, 256, 400, 512, 551, 1024, 1103, 1200, 2048,
# 2646 (the DFT kernel's 8-frame blocks) and 4096
MFCC_SIZES = {128: (8000.0, 10.0, True), 200: (8000.0, 25.0, False), 256: (8000.0, 25.0, True),
              400: (16000.0, 25.0, False), 512: (16000.0, 25.0, True),
              551: (22050.0, 25.0, False), 1024: (22050.0, 25.0, True),
              1103: (44100.0, 25.02, False), 1200: (48000.0, 25.0, False),
              2048: (48000.0, 25.0, True), 2646: (44100.0, 60.0, False),
              4096: (48000.0, 60.0, True)}


def _mfcc_opts(n_fft, variant="default", **override):
    sr, ms, pow2 = MFCC_SIZES[n_fft]
    fo = dict(samp_freq=sr, frame_length_ms=ms, round_to_power_of_two=pow2, dither=0.0)
    fo.update(override)
    mo = dict(num_bins=23)
    kw = {}
    if variant == "no_dc_no_preemph":
        fo.update(remove_dc_offset=False, preemph_coeff=0.0)
    elif variant == "windowed_energy":
        kw["raw_energy"] = False
    elif variant == "htk_mode":
        mo["htk_mode"] = True
    elif variant == "hamming":
        fo["window_type"] = "hamming"
    elif variant == "wide_bank":  # 80 bins, 40 cepstra
        mo["num_bins"], kw["num_ceps"] = 80, 40
    opts = MfccOptions(frame_opts=FrameOptions(**fo), mel_opts=MelOptions(**mo), **kw)
    assert override or opts.frame_opts.padded_window_size == n_fft
    return opts


@pytest.mark.parametrize("n_fft", sorted(MFCC_SIZES))
@pytest.mark.parametrize("variant", ["default", "fbank", "no_dc_no_preemph",
                                     "windowed_energy", "htk_mode", "hamming", "wide_bank"])
def test_mfcc_kernel_matches_plain(cuda, n_fft, variant):
    opts = _mfcc_opts(n_fft, variant)
    fo = opts.frame_opts
    tables = TF.MfccTables.build(opts, variant == "fbank", cuda)
    frames = torch.from_numpy(_frames(fo.samp_freq, fo.window_size, 333, seed=1)).to(cuda)
    if opts.mel_opts.num_bins > n_fft // 2:  # 80 bins on a 64-bin spectrum
        with pytest.raises(ValueError, match="do not fit"):
            mfcc_kernel.mfcc_frames(frames, tables)
        return
    before = _build.launches["mfcc_frames"]
    got = mfcc_kernel.mfcc_frames(frames, tables)
    ref = TF.mfcc_from_frames(frames, tables)
    torch.cuda.synchronize()
    assert _build.launches["mfcc_frames"] == before + 1
    assert got.shape == ref.shape == (333, tables.out_cols)
    if variant == "wide_bank":
        # 80 bins: the lowest hold one or two FFT bins, which preemphasis
        # leaves about 1e-3 below the frame's power, and fp32 rounding alone
        # moves their logs past atol (the plain version misses the float64
        # chain by up to 2.7 times the tolerance): both are held to the
        # float64 chain instead
        t64 = dataclasses.replace(tables, **{f: getattr(tables, f).double()
                                             for f in ("window", "mel_t", "dct_t", "lifter")})
        ref = TF.mfcc_from_frames(frames.double(), t64).float()
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n_fft", [256, 400, 512, 1024, 2048])
def test_mfcc_sparse_mel_equals_dense(cuda, n_fft):
    """Each mel bin summed over its own triangle gives the same bits as the
    dense loop over every FFT bin (tables with lo 0 and every bin)."""
    opts = _mfcc_opts(n_fft)
    fo = opts.frame_opts
    frames = torch.from_numpy(_frames(fo.samp_freq, fo.window_size, 517, seed=2)).to(cuda)
    for fbank in (True, False):
        tables = TF.MfccTables.build(opts, fbank, cuda)
        nb, half = tables.mel_t.shape[1], n_fft // 2
        dense = dataclasses.replace(
            tables, mel_lo=torch.zeros(nb, dtype=torch.int32, device=cuda),
            mel_len=torch.full((nb,), half, dtype=torch.int32, device=cuda),
            mel_band=tables.mel_t)
        assert int(tables.mel_len.sum()) < nb * half // 4
        got = mfcc_kernel.mfcc_frames(frames, tables)
        want = mfcc_kernel.mfcc_frames(frames, dense)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_mfcc_kernel_refuses_above_4096(cuda):
    opts = _mfcc_opts(4096, frame_length_ms=100.0)  # 4800 samples -> 8192 points
    tables = TF.MfccTables.build(opts, False, cuda)
    frames = torch.zeros((4, opts.frame_opts.window_size), device=cuda)
    with pytest.raises(ValueError, match="at most 4096"):
        mfcc_kernel.mfcc_frames(frames, tables)


def _am(num_pdfs, max_mix, dim, seed, ragged):
    rng = np.random.default_rng(seed)
    inv_vars = np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32) + 0.3
    means = rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32)
    weights = rng.random((num_pdfs, max_mix)).astype(np.float32)
    if ragged:
        for p in range(num_pdfs):
            weights[p, rng.integers(0, max_mix + 1):] = 0.0  # some pdfs all inactive
    weights /= np.maximum(weights.sum(axis=1, keepdims=True), 1e-30)
    return AmDiagGmm(means * inv_vars, inv_vars, weights)


def _feature_scale_case(which, device):
    """Features on their own scale: the Yes-No test (or train) corpus
    through the port's front end (MFCC, CMVN, deltas), with the committed
    Yes-No model or a 200 x 5 GMM drawn on the features' scale (variances /
    30, as chip_smoke.py's lattice phase)."""
    train, test = make_corpus(num_train=24, num_test=8, seed=7)
    corpus = train if which == "yesno_train" else test
    feats = make_features({u: w for u, (w, _) in corpus.items()}, {u: u for u in corpus},
                          MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=0.0)),
                          device=device)
    x = torch.cat([feats[u] for u in sorted(feats)]).contiguous()
    if which.startswith("yesno"):
        am = load_yesno_mono().am
    else:
        xd = x.double().cpu().numpy()
        am = feature_scaled_am(xd.mean(0), xd.var(0) / 30.0, 200, 5)
    return x, gmm_kernels.pack_gmm(am, device)


# (pdfs, components, dim, frames, ragged mixtures): ragged frames and pdfs
# on every edge of the 128-frame x 16-pdf tile and of the 64-pdf padding
GMM_CASES = [
    (37, 5, 13, 300, False), (21, 7, 11, 64, True), (130, 3, 39, 1000, False),
    (65, 2, 80, 129, False), (1, 1, 13, 1, False), (15, 4, 39, 127, False),
    (16, 5, 39, 128, False), (17, 6, 40, 129, True), (63, 8, 39, 255, False),
    (64, 1, 80, 257, False), (65, 5, 39, 384, True), (200, 5, 39, 2000, False),
    (33, 8, 13, 100, True), (129, 2, 40, 3, False), (34, 9, 40, 700, True),
    (100, 11, 40, 513, True), "feature_scaled", "yesno", "yesno_train"]
# ragged layouts (tests/k2_cases.py): (dim, frames)
LIVE_CASES = {"tri2b_libri": (40, 2000), "tri5b_libri": (40, 300), "dead_between": (13, 257),
              "all_dead_beside_16": (39, 129), "one_gaussian": (40, 200), "ragged_p": (40, 301),
              "uniform": (39, 500)}


@pytest.mark.parametrize("case", GMM_CASES + list(LIVE_CASES), ids=str)
def test_gmm_kernel_matches_plain(cuda, case):
    """K2 against its plain version run in float64: on the Yes-No model's
    training features the expanded form cancels terms of up to 1e4, and the
    fp32 plain version is itself 1.2 times the tolerance away from it on the
    card.  The ragged cases score only the live Gaussians (the benchmark's
    drawn mixtures, dead slots between live ones, a pdf with none in a
    sub-tile of 16-Gaussian pdfs, one Gaussian a pdf, 150 pdfs, a uniform
    model)."""
    if case in LIVE_CASES:
        dim, n = LIVE_CASES[case]
        w = gmm_kernels.pack_gmm(
            k2_cases.am_with_live(k2_cases.live_mask(case), dim, seed=dim), cuda)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((n, dim))
                             .astype(np.float32)).to(cuda)
    elif isinstance(case, str):
        x, w = _feature_scale_case(case, cuda)
    else:
        num_pdfs, max_mix, dim, n, ragged = case
        am = _am(num_pdfs, max_mix, dim, seed=dim + max_mix, ragged=ragged)
        w = gmm_kernels.pack_gmm(am, cuda)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, dim))
                             .astype(np.float32)).to(cuda)
    before = _build.launches["gmm_loglikes"]
    got = gmm_kernel.loglikes(x, w)
    ref = gmm_kernels.loglikes(w.to(torch.float64), x.double())
    torch.cuda.synchronize()
    assert _build.launches["gmm_loglikes"] == before + 1
    torch.testing.assert_close(got.double(), ref, rtol=2e-5, atol=2e-4)


def test_cmvn_and_transition_stats_bit_equal_between_runs(cuda):
    """No float atomics: CMVN statistics of 128 utterances of 8 speakers and
    transition statistics of 77k frames with fractional weights are the
    same bits in two runs, and agree with the CPU."""
    rng = np.random.default_rng(12)
    feats = torch.from_numpy((rng.standard_normal((128, 1000, 13)) * 5 + 3)
                             .astype(np.float32)).to(cuda)
    nf = torch.from_numpy(rng.integers(500, 1001, 128).astype(np.int32)).to(cuda)
    spk = torch.from_numpy(rng.permutation(np.arange(128) % 8).astype(np.int32)).to(cuda)
    tids = torch.from_numpy(rng.integers(1, 1500, 76800).astype(np.int32)).to(cuda)
    tids[::3] = 17  # a long run
    w = torch.from_numpy(rng.random(76800).astype(np.float32)).to(cuda)
    runs = [(TC.acc_cmvn_stats_batch(feats, nf, spk, 8),
             gmm_kernels.acc_transition_stats(tids, 1600, w)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cpu = (TC.acc_cmvn_stats_batch(feats.cpu(), nf.cpu(), spk.cpu(), 8),
           gmm_kernels.acc_transition_stats(tids.cpu(), 1600, w.cpu()))
    for a, b in zip(runs[0], cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-3)
    assert runs[0][1][0] == 0 and runs[0][1][1599] == 0


def _hub_graph(seed):
    """A graph whose hub state has hundreds of in-degree rows, so the
    backpointer codes need int16."""
    g = synth_decode_graph(500, arcs_per_state=4, num_pdfs=40, seed=seed)
    rng = np.random.default_rng(seed)
    extra = 400
    src = np.concatenate([g.arc_src, rng.integers(0, 500, extra).astype(np.int32)])
    dst = np.concatenate([g.arc_dst, np.full(extra, 7, np.int32)])
    pdf = np.concatenate([g.arc_pdf, rng.integers(0, 40, extra).astype(np.int32)])
    score = np.concatenate([g.arc_score, (-rng.exponential(1.0, extra)).astype(np.float32)])
    return g._replace(arc_src=src, arc_dst=dst, arc_pdf=pdf, arc_tid=pdf, arc_score=score,
                      arc_oseq=np.zeros_like(src))


def _k3_graph(which):
    """The packed graph (with 33, 41 and 50 more arcs into states 9, 19 and
    29, so that every row width leaves bucket-padding rows) or the hub graph,
    with every arc into states 5, 102, 199, ... and every arc out of states
    11, 108, 205, ... removed: those states keep one dead row, all padding,
    in the forward and the backward plan."""
    if which == "packed":
        g = synth_decode_graph(700, num_pdfs=40)
        rng = np.random.default_rng(1)
        dst = np.repeat(np.array([9, 19, 29], np.int32), [33, 41, 50])
        src = rng.integers(0, 700, len(dst)).astype(np.int32)
        pdf = np.array([g.arc_pdf[g.arc_dst == x][0] for x in dst], np.int32)
        score = (-rng.exponential(1.0, len(dst))).astype(np.float32)
        g = g._replace(arc_src=np.concatenate([g.arc_src, src]),
                       arc_dst=np.concatenate([g.arc_dst, dst]),
                       arc_pdf=np.concatenate([g.arc_pdf, pdf]),
                       arc_tid=np.concatenate([g.arc_tid, pdf]),
                       arc_score=np.concatenate([g.arc_score, score]),
                       arc_oseq=np.zeros(len(g.arc_src) + len(dst), np.int32))
    else:
        g = _hub_graph(3)
    keep = (g.arc_dst % 97 != 5) & (g.arc_src % 97 != 11)
    return g._replace(**{f: getattr(g, f)[keep] for f in
                         ("arc_src", "arc_dst", "arc_pdf", "arc_tid", "arc_score", "arc_oseq")})


K3_FRAMES = 8  # not a multiple of the window 3
# (graph, row width D, lanes B, window W, block cap, plan); D = 12 takes the
# runtime-D kernel, a block cap of 1 makes one block's stride loop cover
# every state, W = K3_FRAMES is one launch for the whole utterance
K3_CASES = [
    ("packed", 4, 40, 1, 0, "fwd"), ("int16", 4, 40, 1, 0, "fwd"),
    ("packed", 1, 5, 3, 0, "fwd"), ("packed", 2, 128, K3_FRAMES, 0, "fwd"),
    ("packed", 3, 130, 3, 0, "fwd"), ("int16", 5, 1, K3_FRAMES, 0, "fwd"),
    ("packed", 6, 128, 3, 1, "fwd"), ("packed", 7, 130, 1, 1, "fwd"),
    ("int16", 8, 128, 3, 0, "fwd"), ("int16", 12, 5, 3, 0, "fwd"),
    ("packed", 12, 130, K3_FRAMES, 1, "fwd"), ("packed", 2, 128, 3, 0, "bwd"),
    ("packed", 2, 130, K3_FRAMES, 1, "bwd"), ("packed", 8, 5, 1, 0, "bwd"),
    ("int16", 4, 1, 3, 0, "bwd"), ("packed", 12, 128, 3, 0, "bwd"),
]


@pytest.mark.parametrize("which,d,b,window,blocks,plan_kind", K3_CASES)
def test_viterbi_step_matches_plain(cuda, monkeypatch, which, d, b, window, blocks, plan_kind):
    """K3 against its plain version on the same CUDA tensors, window by
    window (W = 1 through ``viterbi_step``): bit-equal scores, alpha_end and
    backpointer codes over the forward plan; bit-equal beta and beta_eff slab
    over the lattice's backward plan.  Lanes end before, inside and after
    the windows; the plans hold dead rows and bucket-padding rows."""
    monkeypatch.setattr(DC, "_MAX_GRID_BLOCKS", blocks)
    graph = _k3_graph(which)
    if plan_kind == "fwd":
        plan = DC.build_emit_plan(graph, d=d)
        assert plan.packed == (which == "packed")
    else:
        plan = LAT.build_lattice_plans(graph, d=d, device="cpu")[2]
    assert plan.d == d
    real = DC.row_real_slots(plan)
    s1 = plan.num_states + 1
    dead = (np.diff(plan.row_start)[:-1] == 1) & (real[plan.row_start[:-2]] == 0)
    assert dead.any() and (real == 0).sum() > dead.sum() + 1  # + bucket padding rows
    dev = DC.plan_to_device(plan, cuda)
    rng = np.random.default_rng(5 + d)
    frames = K3_FRAMES
    ll = torch.from_numpy((rng.standard_normal((frames, 40, b)) * 5 - 30)
                          .astype(np.float32)).to(cuda)
    nf_np = rng.integers(0, frames + 1, b).astype(np.int32)
    nf_np[: min(b, 3)] = [frames, 4, 0][: min(b, 3)]
    nf = torch.from_numpy(nf_np).to(cuda)
    alpha0 = np.concatenate([graph.alpha0[plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    a_k = a_p = torch.from_numpy(alpha0).to(cuda)[:, None].expand(s1, b).contiguous()
    key = "viterbi_step" if plan_kind == "fwd" else "viterbi_step_backward"
    before = _build.launches[key]
    if plan_kind == "bwd":
        beta = (rng.standard_normal((s1, b)) * 4 - 10).astype(np.float32)
        beta[-1] = DC.NEG_INF
        a_k = a_p = torch.from_numpy(beta).to(cuda)
        final_eff = torch.from_numpy(np.where(rng.random((s1, b)) < 0.5, 0.0, DC.NEG_INF)
                                     .astype(np.float32)).to(cuda)
        slab_k = torch.empty((frames, s1, b), device=cuda)
        slab_p = torch.full_like(slab_k, 7.0)
        starts = list(range(0, frames, window))[::-1]
        for lo in starts:
            hi = min(lo + window, frames)
            args = (ll[lo:hi], dev, nf, lo, 0.25, plan.rspec, plan.packed, final_eff)
            a_k = LAT.bwd_window(a_k, *args, slab_k[lo:hi])
            a_p = LAT.bwd_window_plain(a_p, *args, slab_p[lo:hi])
            torch.cuda.synchronize()
            assert torch.equal(a_k, a_p), f"window at {lo}"
        assert torch.equal(slab_k, slab_p)
        assert _build.launches[key] - before == len(starts)
        return
    e_k = torch.full_like(a_k, DC.NEG_INF)
    e_p = e_k.clone()
    dtype = torch.uint8 if plan.packed else torch.int16
    bp_k = torch.empty((frames, s1, b), dtype=dtype, device=cuda)
    bp_p = torch.empty_like(bp_k)
    for lo in range(0, frames, window):
        hi = min(lo + window, frames)
        if window == 1:
            a_k, e_k = DC.viterbi_step(a_k, e_k, ll[lo], dev, nf, lo, 0.25, plan.rspec,
                                       plan.packed, bp_k[lo])
        else:
            a_k, e_k = DC.viterbi_window(a_k, e_k, ll[lo:hi], dev, nf, lo, 0.25, plan.rspec,
                                         plan.packed, bp_k[lo:hi])
        a_p, e_p = DC.viterbi_window_plain(a_p, e_p, ll[lo:hi], dev, nf, lo, 0.25, plan.rspec,
                                           plan.packed, bp_p[lo:hi])
        torch.cuda.synchronize()
        assert torch.equal(a_k, a_p) and torch.equal(e_k, e_p), f"window at {lo}"
        assert torch.equal(bp_k[lo:hi], bp_p[lo:hi]), f"window at {lo}"
    assert _build.launches[key] - before == -(-frames // window)


@pytest.mark.parametrize("budget", [1 << 40, 1])  # keep, recompute
def test_decode_best_path_cuda_matches_cpu(cuda, budget):
    rng = np.random.default_rng(0)
    s, a, p = 60, 400, 9
    alpha0 = np.full(s, DC.NEG_INF, np.float32)
    alpha0[0] = 0.0
    final = np.full(s, DC.NEG_INF, np.float32)
    final[rng.choice(s, 10, replace=False)] = 0.0
    pdf = rng.integers(0, p, a).astype(np.int32)
    graph = DenseGraph(
        num_states=s, arc_src=rng.integers(0, s, a).astype(np.int32),
        arc_dst=rng.integers(0, s, a).astype(np.int32), arc_tid=pdf + 1, arc_pdf=pdf,
        arc_score=(-rng.random(a) * 3).astype(np.float32),
        arc_oseq=rng.integers(0, 3, a).astype(np.int32), alpha0=alpha0,
        start_oseq=np.zeros(s, np.int32), final_score=final,
        final_oseq=np.zeros(s, np.int32), oseqs=[(), (5,), (6, 7)])
    plan = DC.build_emit_plan(graph, d=4)
    ll = rng.standard_normal((6, 50, p)).astype(np.float32)
    nf = np.array([50, 49, 17, 1, 0, 33], np.int32)
    before = _build.launches["backtrace_best"]
    got = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, cuda),
                              torch.from_numpy(ll).to(cuda), nf, 0.5, bp_bytes_budget=budget)
    blocks = _build.launches["backtrace_best"] - before
    ref = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, "cpu"),
                              torch.from_numpy(ll), nf, 0.5, bp_bytes_budget=budget)
    assert got == ref
    assert blocks == (1 if budget > 1 else -(-50 // 16))  # recompute: 16-frame blocks


def _wide_band(rng, b, s, offsets, num_pdfs):
    """Band operands drawn directly (no graph): K = len(offsets) slots per
    state, 30 % of them arcs; start at state 0, every state final."""
    k = len(offsets)
    has_arc = rng.random((b, s, k)) < 0.3
    W = np.where(has_arc, -rng.exponential(0.5, (b, s, k)), DC.NEG_INF).astype(np.float32)
    arc_of = np.where(has_arc, np.arange(s * k).reshape(s, k), -1).astype(np.int32)
    alpha0 = np.full((b, s), DC.NEG_INF, np.float32)
    alpha0[:, 0] = 0.0
    return AB.BandPlan(W=W, pdf=rng.integers(0, num_pdfs, (b, s)).astype(np.int32),
                       arc_of=arc_of, offsets=tuple(offsets), alpha0=alpha0,
                       final=np.zeros((b, s), np.float32), n2o=np.zeros((b, s), np.int32))


@pytest.mark.parametrize("case", ["ragged", "failed", "wide_w"])
def test_align_band_matches_plain(cuda, case):
    """K4 forward: bit-equal alpha_end and equal band-slot codes; backtrace:
    equal arcs, end states, ok flags and bit-equal scores."""
    rng = np.random.default_rng(7)
    num_pdfs, t = 30, 90
    if case == "wide_w":  # S x K x 4 bytes = 384 KB: W is read through L2
        plan, t = _wide_band(rng, 3, 2000, range(-20, 28), num_pdfs), 40
        assert plan.W.shape[1] * plan.W.shape[2] * 4 > 227 * 1024
    else:
        graphs = [synth_train_graph(int(rng.integers(10, 40)), num_pdfs, rng)
                  for _ in range(9)]
        if case == "failed":  # needs more than 90 frames for its 300 states
            graphs.append(synth_train_graph(300, num_pdfs, rng))
        plan = AB.build_band_plan(graphs)
    dev = AB.plan_to_device(plan, cuda)
    b = plan.W.shape[0]
    nf = rng.integers(t // 2, t + 1, b).astype(np.int32)
    if case == "ragged":
        nf[[0, 3]] = [0, t]
    nf = torch.from_numpy(nf).to(cuda)
    ll = torch.from_numpy((rng.standard_normal((b, t, num_pdfs)) * 4 - 20)
                          .astype(np.float32)).to(cuda)
    got = AB.viterbi_forward_banded(dev.W, dev.pdf, dev.alpha0, ll, nf, 0.1, dev.offsets)
    ref = AB.viterbi_forward_banded_plain(dev.W, dev.pdf, dev.alpha0, ll, nf, 0.1,
                                          dev.offsets)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    bt = AB.backtrace_banded(got[0], dev.final, got[1], nf, dev.offsets, dev.arc_of)
    bt_ref = AB.backtrace_banded_plain(ref[0], dev.final, ref[1], nf, dev.offsets,
                                       dev.arc_of)
    torch.cuda.synchronize()
    for x, y in zip(bt, bt_ref):
        assert torch.equal(x, y.to(x.dtype))
    if case == "failed":
        assert not bool(bt[2][-1]) and bool(bt[2][:-1].all())


@pytest.mark.parametrize("kind", ["banded", "generic"])
def test_align_feats_to_tids_matches_dicts(cuda, kind, monkeypatch):
    """``align_feats_to_tids`` on the card (banded: K4's backtrace over the
    band plan's ``tid_of``; generic: its arcs gathered to transition ids)
    fills ``tids`` and ``weights`` bit-equal to ``align_feats`` +
    ``apply_alignments`` on the card and to itself on the CPU, over
    sub-batches of four with an utterance too long for its frames and one of
    no frames; two reads a sub-batch."""
    rng = np.random.default_rng(23)
    back = 0 if kind == "banded" else 10  # more than 48 band offsets in all
    graphs = [synth_train_graph(int(n), 30, rng, back_arcs=back)
              for n in rng.integers(160, 200, 9)]
    graphs.insert(2, synth_train_graph(600, 30, rng))  # 450 frames at the least
    graphs = [g._replace(arc_tid=(1000 * i + 1 + rng.permutation(g.num_arcs)).astype(np.int32))
              for i, g in enumerate(graphs)]
    nf = rng.integers(300, 360, len(graphs)).astype(np.int32)
    graphs[6] = synth_train_graph(1, 30, rng)._replace(arc_tid=np.array([6001, 6002], np.int32))
    nf[6] = 0  # start state final: an empty path, a failure as apply_alignments counts it
    feats = rng.standard_normal((len(graphs), int(nf.max()), 13)).astype(np.float32)
    am = random_am(30, 4, 13, seed=24)
    names = [f"u{i}" for i in range(len(graphs))]
    out = {}
    for where in ("cuda", "cpu"):
        device = cuda if where == "cuda" else torch.device("cpu")
        aset = AlignmentSet(graphs, device=device)
        assert (aset.band is None) == (kind == "generic")
        monkeypatch.setattr(aset, "_batch_chunk", lambda *args: 4)
        params = gmm_kernels.pack_gmm(am, device)
        x = torch.from_numpy(feats).to(device)
        tids = np.full(feats.shape[:2], 9, np.int32)
        weights = np.ones(feats.shape[:2], np.float32)
        with P.recording():
            fails = aset.align_feats_to_tids(params, x, nf, tids, weights, "test", names,
                                             acoustic_scale=0.1)
        counters = P.session().counters
        out[where] = (fails, tids, weights)
        if where == "cuda":
            assert counters["align.tid_blocks"] == 3 and counters["host_sync"] == 6
            if kind == "banded":
                assert aset.band_dev.tid_of is not None
            want_t, want_w = np.zeros_like(tids), np.zeros_like(weights)
            want = apply_alignments(aset.align_feats(params, x, nf, acoustic_scale=0.1),
                                    want_t, want_w, nf, "test", names)
            assert fails == want == 2
            np.testing.assert_array_equal(tids, want_t)
            np.testing.assert_array_equal(weights, want_w)
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][2], out["cpu"][2])


@pytest.mark.parametrize("case", ["skew", "zero_weights", "twofeats", "d40_uneven"])
def test_gmm_stats_matches_plain(cuda, case):
    """K6 against the plain version: rtol 1e-5, atol 1e-5 x the largest
    magnitude of each accumulator (float32 scores and posteriors in another
    order; the kernel sums in float64).  ``d40_uneven``: the LDA features'
    40 dimensions and a triphone model's uneven mixture counts (1-9)."""
    rng = np.random.default_rng(11)
    ragged = case in ("twofeats", "d40_uneven")
    d = 40 if case == "d40_uneven" else 13
    am = _am(40, 9 if case == "d40_uneven" else 4, d, seed=3, ragged=ragged)
    w = gmm_kernels.pack_gmm(am, cuda)
    n = 5000
    x_post = rng.standard_normal((n, d)).astype(np.float32)
    x_acc = rng.standard_normal((n, d)).astype(np.float32) if case == "twofeats" else x_post
    pdf = rng.integers(0, 40, n).astype(np.int32)
    if case == "skew":
        pdf[rng.random(n) < 0.8] = 5  # 4000 frames: 16 blocks of one pdf
    if ragged:  # aligned pdfs keep at least one active component
        pdf = np.where(am.weights[pdf].max(axis=1) > 0, pdf, int(np.argmax(am.weights[:, 0])))
    weights = rng.random(n).astype(np.float32)
    if case == "zero_weights":
        weights[rng.random(n) < 0.4] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (x_post, x_acc, pdf, weights)]
    got = gmm_stats_kernel.acc_stats(w, *args, 40)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(w, *args[:3], 40, args[3])
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.double()
        atol = 1e-5 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    again = gmm_stats_kernel.acc_stats(w, *args, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic


# (frames T, lanes, states S, band offsets or None for training graphs of
# 8-40 states, pdfs P): one frame; fewer frames than K4's emission ring
# holds; lanes with no frames; S > 512 (several states per thread, W in
# shared memory); W too large for shared memory, read through L2; and a
# model of 2000 pdfs under graphs of a few states
ALIGN_EDGES = {"t1": (1, 6, None, None, 50), "below_depth": (2, 6, None, None, 50),
               "empty_lanes": (60, 8, None, None, 50),
               "s_above_512": (50, 3, 700, range(-2, 5), 50),
               "wide_w": (7, 3, 2000, range(-20, 28), 50),
               "few_states": (45, 6, None, None, 2000)}


@pytest.mark.parametrize("case", sorted(ALIGN_EDGES))
def test_align_forward_edges(cuda, case):
    """K4's forward at its edges: bit-equal alpha_end and equal band-slot
    codes against the plain version, with the plan's pdf range from the host
    and read from the card alike."""
    rng = np.random.default_rng(17)
    t, b, s, offsets, num_pdfs = ALIGN_EDGES[case]
    if offsets is None:
        plan = AB.build_band_plan([synth_train_graph(int(rng.integers(8, 40)), num_pdfs, rng)
                                   for _ in range(b)])
        assert len(plan.offsets) <= 8 and plan.W.shape[1] <= 512  # W in registers
    else:
        plan = _wide_band(rng, b, s, offsets, num_pdfs)
    dev = AB.plan_to_device(plan, cuda)
    nf = rng.integers(max(1, t // 2), t + 1, b).astype(np.int32)
    if case == "empty_lanes":
        nf[[0, 2, b - 1]] = 0
    nf = torch.from_numpy(nf).to(cuda)
    ll = torch.from_numpy((rng.standard_normal((b, t, num_pdfs)) * 4 - 20)
                          .astype(np.float32)).to(cuda)
    fwd = (dev.W, dev.pdf, dev.alpha0, ll, nf, 0.1, dev.offsets)
    got = AB.viterbi_forward_banded(*fwd, dev.pdf_range)
    read = AB.viterbi_forward_banded(*fwd)
    ref = AB.viterbi_forward_banded_plain(*fwd)
    torch.cuda.synchronize()
    for out in (got, read):
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    with pytest.raises(ValueError, match="loglikes have"):
        AB.viterbi_forward_banded(*fwd, (0, num_pdfs))


# (lanes B, states S, frames T, band offsets, fail rate) of K4's backtrace:
# failures on the path; K = 1 (the walk reaches state 0 and fails at every
# frame after) and K = 12; S not a multiple of 4 (plain byte copies), of 16
# (4-byte copies) and above 512; one lane and 130; 2000 frames of 384
# states, 24 chunks of staged rows; rows too wide to stage two (the walk
# reads global memory); lanes with no frames and no final state
ALIGN_WALKS = {"failures": (6, 60, 300, range(-3, 5), 1 / 50),
               "k1": (5, 40, 100, (1,), 0.0), "k12": (5, 100, 200, range(-5, 7), 1 / 60),
               "s45": (5, 45, 120, range(-2, 3), 1 / 40),
               "s700": (3, 700, 90, range(-2, 5), 1 / 20),
               "b1": (1, 384, 400, range(-2, 5), 1 / 100),
               "b130": (130, 64, 50, range(0, 3), 1 / 100),
               "t2000": (4, 384, 2000, range(-2, 5), 1 / 400),
               "unstaged": (2, 120_000, 20, (0, 1), 0.9),
               "empty_lanes": (8, 96, 70, range(-1, 3), 1 / 20)}


@pytest.mark.parametrize("case", sorted(ALIGN_WALKS))
def test_align_backtrace_edges(cuda, case):
    """K4's backtrace against its plain version on directly drawn
    backpointers: equal arcs, end states and ok flags, bit-equal scores, one
    launch."""
    b, s, t, offsets, fail_rate = ALIGN_WALKS[case]
    rng = np.random.default_rng(sorted(ALIGN_WALKS).index(case) + 61)
    alpha_end, final, bps, nf, arc_of = random_band_walk(rng, b, s, t, offsets, fail_rate)
    if case == "empty_lanes":
        nf[[1, 2, 5]] = [0, 0, 1]
        final[[3, 5]] = DC.NEG_INF
    bt = [torch.from_numpy(x).to(cuda) for x in (alpha_end, final, bps, nf)]
    offs = torch.tensor(list(offsets), dtype=torch.int32, device=cuda)
    bt += [offs, torch.from_numpy(arc_of).to(cuda)]
    before = _build.launches["align_backtrace"]
    got = AB.backtrace_banded(*bt)
    ref = AB.backtrace_banded_plain(*bt)
    torch.cuda.synchronize()
    assert _build.launches["align_backtrace"] - before == 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y.to(x.dtype))
    active = torch.arange(t, device=cuda)[:, None] < bt[3][None, :]
    failed = ((got[0] < 0) & active).any(dim=0)
    if fail_rate > 0 or case == "k1":  # some walks fail, and their flags say so
        assert bool(failed.any()) and not bool(got[2][failed].any())


# (frames N, pdfs of the model P, pdfs counted): every frame on one pdf;
# fewer pdfs counted than the model has; N below one chunk of the card's
# sort; pdfs with no frames; no frame of nonzero weight; more chunks than
# the sort's grid holds at once; pdfs too many for 8 warps' counts in
# shared memory
STATS_EDGES = {"one_pdf": (3000, 40, 40), "fewer_pdfs": (4000, 40, 25),
               "below_chunk": (100, 40, 40), "empty_pdfs": (2000, 300, 300),
               "no_frames": (500, 40, 40), "many_chunks": (1_500_000, 2000, 2000),
               "many_pdfs": (50_000, 12_000, 12_000)}


@pytest.mark.parametrize("case", sorted(STATS_EDGES))
def test_gmm_stats_edges(cuda, case):
    """K6 at its edges: the work list built on the card equals the plain
    one (``torch.sort`` + ``block_table``) bit for bit, the statistics match
    the plain version (rtol 1e-5, atol 1e-5 x each accumulator's largest
    magnitude), and two runs give the same bits."""
    rng = np.random.default_rng(23)
    n, p, num_pdfs = STATS_EDGES[case]
    d = 13
    w = gmm_kernels.pack_gmm(_am(p, 3, d, seed=5, ragged=False), cuda)
    x = rng.standard_normal((n, d)).astype(np.float32)
    pdf = rng.integers(0, num_pdfs, n).astype(np.int32)
    if case == "one_pdf":
        pdf[:] = 7
    elif case == "empty_pdfs":
        pdf = rng.integers(0, 20, n).astype(np.int32) * 15  # 20 of 300 pdfs
    weights = rng.random(n).astype(np.float32)
    weights[rng.random(n) < 0.2] = 0.0
    if case == "no_frames":
        weights[:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (x, x, pdf, weights)]
    # the list also on pdfs outside [0, num_pdfs), which it leaves out (the
    # plain statistics cannot take them)
    outside = np.where(rng.random(n) < 0.1, rng.integers(-2, 3, n) + (num_pdfs - 1) * (pdf > 5),
                       pdf).astype(np.int32)
    for pdf_t in (args[2], torch.from_numpy(outside).to(cuda)):
        got_list = gmm_stats_kernel.work_list(pdf_t, args[3], num_pdfs)
        ref_list = gmm_stats_kernel.work_list_plain(pdf_t, args[3], num_pdfs)
        torch.cuda.synchronize()
        for name, g, r in zip(ref_list._fields, got_list, ref_list):
            assert torch.equal(g, r), name
    got = gmm_stats_kernel.acc_stats(w, *args, num_pdfs)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(w, *args[:3], num_pdfs, args[3])
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.double()
        atol = 1e-5 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    again = gmm_stats_kernel.acc_stats(w, *args, num_pdfs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


FB_FRAMES = 40
FB_LANES = {"ten": np.array([0, 1, FB_FRAMES, 37, 3, 20, FB_FRAMES, 12, 29, 5], np.int32)}
for _b in (1, 5, 128, 130):  # lane 0 empty, the others 1 .. T frames
    FB_LANES[_b] = np.random.default_rng(_b).integers(1, FB_FRAMES + 1, _b).astype(np.int32)
    FB_LANES[_b][0] = 0 if _b > 1 else FB_FRAMES
# (row width D, lanes, window W, block cap): W = 1, a window that does not
# divide T, W = T; a block cap of 1 makes one block's stride loop cover
# every state
FB_CASES = [(2, "ten", 3, 0), (8, "ten", 16, 0), (8, "ten", 1, 0), (2, "ten", FB_FRAMES, 0),
            (4, 1, 3, 0), (1, 5, FB_FRAMES, 1), (3, 128, 3, 0), (5, 130, 7, 1),
            (6, 128, 1, 1), (7, 5, 3, 0)]


@pytest.mark.parametrize("d,lanes,window,blocks", FB_CASES)
def test_lattice_fb_matches_plain(cuda, monkeypatch, d, lanes, window, blocks):
    """The whole lattice forward-backward with K3 and K5 against the same run
    with their plain versions, on the same CUDA tensors: identical
    survivors and bit-equal total_best and alpha_at_end; one launch per
    window and pass.  Lanes of 0, 1 and T frames, ragged ones, and lanes
    that reach no final state."""
    monkeypatch.setattr(DC, "_MAX_GRID_BLOCKS", blocks)
    graph = synth_decode_graph(700, num_pdfs=40, seed=2)
    final = np.full(700, DC.NEG_INF, np.float32)
    final[600:] = 0.0  # more than 3 frames of jumps of at most 63 from state 0
    graph = graph._replace(final_score=final)
    plans = LAT.build_lattice_plans(graph, d=d, device=cuda)
    assert plans[0].d == d
    t = FB_FRAMES
    nf = FB_LANES[lanes]
    rng = np.random.default_rng(9)
    ll = torch.from_numpy((rng.standard_normal((len(nf), t, 40)) * 5 - 30)
                          .astype(np.float32)).to(cuda)
    args = (graph, *plans, ll, nf, 0.25, 6.0)
    keys = ("viterbi_step", "viterbi_step_backward", "lattice_fb")
    before = {k: _build.launches[k] for k in keys}
    got = LAT.lattice_forward_backward_rows(*args, window=window)
    torch.cuda.synchronize()
    windows = -(-int(nf.max()) // window)
    assert all(_build.launches[k] - before[k] == windows for k in keys)
    monkeypatch.setattr(LAT, "fb_frames", LAT.fb_frames_plain)
    monkeypatch.setattr(LAT, "bwd_window", LAT.bwd_window_plain)
    monkeypatch.setattr(DC, "viterbi_window", DC.viterbi_window_plain)
    ref = LAT.lattice_forward_backward_rows(*args, window=window)
    torch.cuda.synchronize()
    assert all(_build.launches[k] - before[k] == windows for k in keys)
    surv, surv_ref = got[0], ref[0]
    for x, y in zip(surv[:3], surv_ref[:3]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(surv.counts, surv_ref.counts)
    assert (surv.counts[nf == 0] == 0).all() and (surv.counts[nf > 0] > 0).all()
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)
    if lanes == "ten":
        assert got[3].cpu().tolist() == [False, False, True, True, False, True, True, True,
                                         True, False]


def test_decode_lattice_cuda_matches_cpu(cuda):
    """decode_lattice on the card against decode_lattice on the CPU over a
    2000-state graph: identical arc_t/arc_id, acoustic costs within 2e-5
    relative (K2 against its plain version)."""
    graph = synth_decode_graph(2000, num_pdfs=30, seed=1)
    am = random_am(30, 3, 13, seed=2)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((6, 60, 13)).astype(np.float32)
    nf = np.array([60, 0, 31, 1, 59, 60], np.int32)
    utts = [f"u{i}" for i in range(len(nf))]
    # acoustic scale 1: gammas spread wide, so the two loglik versions' 1e-6
    # differences move no arc instance across the lattice beam
    opts = DecodeOptions(acoustic_scale=1.0, lattice_beam=4.0)
    lats = {}
    for dev in (cuda, "cpu"):
        dec = Decoder.from_dense_graph(graph, am, opts, device=dev, row_width=8)
        lats[str(dev)] = dec.decode_lattice(utts, feats, nf)
    for u, n in zip(utts, nf):
        a, b = lats[str(cuda)][u], lats["cpu"][u]
        assert a.nf == b.nf == n and a.use_final == b.use_final
        np.testing.assert_array_equal(a.arc_t, b.arc_t)
        np.testing.assert_array_equal(a.arc_id, b.arc_id)
        np.testing.assert_allclose(a.acoustic_cost, b.acoustic_cost, rtol=2e-5, atol=0)
        assert a.num_arcs >= n


NB_FRAMES = 14  # not a multiple of the window 3
# (list length K, lanes B, window W, block cap, beam): W = NB_FRAMES is one
# launch for the whole utterance; a block cap of 1 makes one block's stride
# loop cover every (state, lane group); K of 4, 8 and 16 take the vector
# loads, 1, 3 and 5 the scalar ones; 33 lanes leave a group of one
NBEST_CASES = [
    (1, 5, 1, 0, 1e9), (1, 33, NB_FRAMES, 1, 5.0), (3, 33, 3, 0, 5.0), (3, 1, NB_FRAMES, 0, 5.0),
    (4, 32, NB_FRAMES, 0, 5.0), (4, 1, 3, 1, 1e9), (4, 5, 3, 0, 5.0), (4, 33, 1, 0, 1e9),
    (5, 32, 3, 0, 5.0), (8, 5, NB_FRAMES, 1, 5.0), (8, 32, 1, 1, 1e9), (16, 33, 1, 0, 5.0),
    (16, 32, 3, 0, 1e9), (16, 1, NB_FRAMES, 1, 5.0),
]


@pytest.mark.parametrize("nbest,b,window,blocks,beam", NBEST_CASES)
def test_nbest_step_matches_plain(cuda, monkeypatch, nbest, b, window, blocks, beam):
    """K7 window by window (W = 1 through ``nbest_step``) against its plain
    version on the same CUDA tensors: bit-equal scores and alpha_end, equal
    arcs and slots, frame by frame; lanes that end before, inside and after
    the windows, and an empty one; one launch per window."""
    monkeypatch.setattr(DC, "_MAX_GRID_BLOCKS", blocks)
    g = synth_decode_graph(700, arcs_per_state=5, num_pdfs=40, seed=nbest)
    plan = V.build_nbest_plan(g, cuda)
    rng = np.random.default_rng(nbest + b)
    t_total, s = NB_FRAMES, g.num_states
    ll = torch.from_numpy((rng.standard_normal((t_total, 40, b)) * 3).astype(np.float32)).to(cuda)
    nf_np = rng.integers(0, t_total + 1, b).astype(np.int32)
    nf_np[: min(b, 4)] = [t_total, 4, 0, 1][: min(b, 4)]
    nf = torch.from_numpy(nf_np).to(cuda)
    a_k = torch.full((s, b, nbest), V.NEG_INF, device=cuda)
    a_k[:, :, 0] = torch.from_numpy(g.alpha0).to(cuda)[:, None]
    a_p = a_k
    e_k = torch.where((nf == 0)[None, :, None], a_k, torch.full_like(a_k, V.NEG_INF))
    e_p = e_k.clone()
    arc_k = torch.empty((t_total, s, b, nbest), dtype=torch.int32, device=cuda)
    slot_k = torch.empty((t_total, s, b, nbest), dtype=torch.int8, device=cuda)
    arc_p, slot_p = torch.full_like(arc_k, 7), torch.full_like(slot_k, 7)
    before = _build.launches["viterbi_nbest"]
    for lo in range(0, t_total, window):
        hi = min(lo + window, t_total)
        if window == 1:
            a_k, e_k = V.nbest_step(plan, a_k, e_k, ll[lo], nf, lo, 0.7, beam, arc_k[lo],
                                    slot_k[lo])
        else:
            a_k, e_k = V.nbest_window(plan, a_k, e_k, ll[lo:hi], nf, lo, 0.7, beam, arc_k[lo:hi],
                                      slot_k[lo:hi])
        a_p, e_p = V.nbest_window_plain(plan, a_p, e_p, ll[lo:hi], nf, lo, 0.7, beam,
                                        arc_p[lo:hi], slot_p[lo:hi])
        torch.cuda.synchronize()
        assert torch.equal(a_k, a_p) and torch.equal(e_k, e_p), f"window at {lo}"
        for t in range(lo, hi):
            assert torch.equal(arc_k[t], arc_p[t]) and torch.equal(slot_k[t], slot_p[t]), t
        a_p = a_k.clone()  # the next window starts from the kernel's scores
    assert _build.launches["viterbi_nbest"] - before == -(-t_total // window)
    assert int((arc_k >= 0).sum()) > 0
    if beam < 1e8:
        assert int(((arc_k < 0) & (slot_k == 0)).sum()) > 0


@pytest.mark.parametrize("b", [1, 5, 128, 130])
@pytest.mark.parametrize("t", [1, 3, 1000])
def test_backtrace_best_matches_plain(cuda, b, t):
    """``backtrace_best`` against its plain version on random codes of the
    K3 test graphs (uint8 codes for even B, int16 for odd): equal codes,
    arcs and states, over two blocks walked in reverse with the state
    carried; lanes that end before, inside and after each block."""
    graph = _k3_graph("packed" if b % 2 == 0 else "int16")
    plan = DC.build_emit_plan(graph, d=4)
    dev = DC.plan_to_device(plan, cuda)
    rng = np.random.default_rng(b + t)
    bps = torch.from_numpy(random_codes(rng, plan, t, b)).to(cuda)
    nf = torch.from_numpy(rng.integers(0, t + 1, b).astype(np.int32)).to(cuda)
    nf[0] = t
    state_k = state_p = torch.from_numpy(rng.integers(0, plan.num_states, b)
                                         .astype(np.int32)).to(cuda)
    cut = t // 2
    before = _build.launches["backtrace_best"]
    for lo, hi in ((cut, t), (0, cut)):
        codes_k, arcs_k, state_k = DC.backtrace_scan(dev, bps[lo:hi], state_k, nf, lo)
        codes_p, arcs_p, state_p = DC.backtrace_scan_plain(
            dev.row_start, dev.row_src, dev.row_arc, plan.d, bps[lo:hi], state_p, nf, lo)
        torch.cuda.synchronize()
        assert torch.equal(codes_k, codes_p) and torch.equal(arcs_k, arcs_p), (lo, hi)
        assert torch.equal(state_k, state_p), (lo, hi)
    assert _build.launches["backtrace_best"] - before == 2
    assert int((codes_k >= 0).sum()) > 0 or cut == 0


# (graph, row width D, lanes B, frames T, block start t0): D = 1, 8 and 12;
# an empty block after frames; a block that starts at frame 40 with lanes
# ending before, inside and after it; the walk starts at the hub state, so
# its first code lies past the 32 slots a warp speculates on; 81,402 more
# rows than states, past the 16-bit row starts of shared memory (the walk
# reads them from global memory)
BEST_EDGES = {"d1": ("packed", 1, 33, 60, 0), "d8": ("int16", 8, 64, 200, 0),
              "d12": ("packed", 12, 5, 100, 0), "empty_block": ("packed", 4, 7, 0, 30),
              "t0_inside": ("int16", 4, 130, 50, 40), "hub_start": ("int16", 2, 9, 40, 0),
              "wide_rows": ("wide_rows", 1, 6, 300, 0)}


@pytest.mark.parametrize("case", sorted(BEST_EDGES))
def test_backtrace_best_edges(cuda, case):
    """``backtrace_best`` at its edges: equal codes, arcs and states against
    the plain version, one launch."""
    which, d, b, w, t0 = BEST_EDGES[case]
    graph = (synth_decode_graph(10_000, num_pdfs=40) if which == "wide_rows"
             else _k3_graph(which))
    plan = DC.build_emit_plan(graph, d=d)
    if which == "wide_rows":
        assert plan.num_rows - (plan.num_states + 1) >= 1 << 16
    dev = DC.plan_to_device(plan, cuda)
    rng = np.random.default_rng(sorted(BEST_EDGES).index(case) + 5)
    bps = torch.from_numpy(random_codes(rng, plan, w, b)).to(cuda)
    nf = torch.from_numpy(rng.integers(0, t0 + w + 20, b).astype(np.int32)).to(cuda)
    state = rng.integers(0, plan.num_states, b).astype(np.int32)
    if case == "hub_start":  # plan state of graph state 7, 400 arcs in
        state[:] = int(np.flatnonzero(plan.sperm == 7)[0])
        nf[:] = w
        assert int(np.diff(plan.row_start)[state[0]]) * d > 32
    state = torch.from_numpy(state).to(cuda)
    before = _build.launches["backtrace_best"]
    got = DC.backtrace_scan(dev, bps, state, nf, t0)
    ref = DC.backtrace_scan_plain(dev.row_start, dev.row_src, dev.row_arc, plan.d, bps, state,
                                  nf, t0)
    torch.cuda.synchronize()
    assert _build.launches["backtrace_best"] - before == 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    if case == "t0_inside":
        ends = nf - t0
        assert bool(((ends > 0) & (ends < w)).any()) and bool((ends <= 0).any())


def _hub_nbest_graph(seed, extra=40):
    """A 60-state synthetic graph with ``extra`` more arcs into state 5 (44
    in-arcs by default, past the 32 slots a warp of the N-best walk reads),
    arc ids shuffled so that the hub's arcs interleave with the others."""
    g = synth_decode_graph(60, arcs_per_state=4, num_pdfs=10, seed=seed)
    rng = np.random.default_rng(seed)
    src = np.concatenate([g.arc_src, rng.integers(0, 60, extra).astype(np.int32)])
    dst = np.concatenate([g.arc_dst, np.full(extra, 5, np.int32)])
    perm = rng.permutation(src.shape[0])
    zeros = np.zeros(src.shape[0], np.int32)
    return g._replace(arc_src=src[perm], arc_dst=dst[perm], arc_tid=zeros, arc_pdf=zeros,
                      arc_score=np.zeros(src.shape[0], np.float32), arc_oseq=zeros)


def _nbest_walk_inputs(tables, b, t, device):
    """(plan, bp_arc, bp_slot, num_frames, state, slot) for the N-best walk
    over K7's lane-minor tables, read through [T, B, S, K] views, 16 walks a
    lane.  ``random``: random provenance (about 40 % of the lanes' walks
    meet arc -1), lanes ending before T and one with no frames; ``hub``:
    the same on ``_hub_nbest_graph``, the hub's backpointers drawn from its
    in-arcs past the 32nd, every walk starting there, and one backpointer
    in four an arc of another state (hand-made: K7 writes none);
    ``wide_hub``: the same with 66,000 arcs into the hub, so that the row
    starts have no 16-bit compact form and the walk reads them from global
    memory; ``k7``: the
    tables K7 writes from random logliks at beam 4, walked from the 16 best
    end entries of each lane, as ``backtrace_nbest_device`` walks them."""
    rng = np.random.default_rng(b * t + len(tables))
    c, k = 16, 4
    if tables in ("hub", "wide_hub"):
        g = _hub_nbest_graph(b, 66_000 if tables == "wide_hub" else 40)
    else:
        g = synth_decode_graph(60, arcs_per_state=4, num_pdfs=10, seed=b)
    s = g.num_states
    plan = V.build_nbest_plan(g, device)
    assert (plan.in_off.numel() == 0) == (tables == "wide_hub")
    nf_np = rng.integers(0, t + 1, b).astype(np.int32)
    nf_np[0] = t
    if b > 1:
        nf_np[1] = 0
    nf = torch.from_numpy(nf_np).to(device)
    if tables == "k7":
        ll = torch.from_numpy(rng.standard_normal((b, t, 10)).astype(np.float32) * 3)
        ae, bp_arc, bp_slot = V.viterbi_nbest_forward(plan, g.alpha0, ll.to(device), nf_np, 0.7,
                                                      4.0, k)
        fidx = (ae + plan.final[None, :, None]).reshape(b, s * k).sort(
            dim=1, descending=True, stable=True)[1][:, :c]
        return (plan, bp_arc, bp_slot, nf, (fidx // k).to(torch.int32),
                (fidx % k).to(torch.int32))
    by_dst = [np.flatnonzero(g.arc_dst == x) for x in range(s)]
    arc = np.stack([rng.choice(by_dst[x], size=(t, b, k)) for x in range(s)], axis=1)
    state = rng.integers(0, s, (b, c)).astype(np.int32)
    if tables in ("hub", "wide_hub"):
        assert by_dst[5].shape[0] > 32
        arc[:, 5] = rng.choice(by_dst[5][32:], size=(t, b, k))
        foreign = rng.random(arc.shape) < 0.25
        arc[foreign] = rng.integers(0, g.num_arcs, int(foreign.sum()))
        state[:] = 5
    arc[rng.random(arc.shape) < 0.5 / t] = -1
    slot = rng.integers(0, k, arc.shape).astype(np.int8)
    return (plan, torch.from_numpy(arc.astype(np.int32)).to(device).permute(0, 2, 1, 3),
            torch.from_numpy(slot).to(device).permute(0, 2, 1, 3), nf,
            torch.from_numpy(state).to(device),
            torch.from_numpy(rng.integers(0, k, (b, c)).astype(np.int32)).to(device))


@pytest.mark.parametrize("tables", ["random", "hub", "wide_hub", "k7"])
@pytest.mark.parametrize("b", [1, 5, 32, 128, 130])
@pytest.mark.parametrize("t", [1, 3, 1000])
def test_backtrace_nbest_matches_plain(cuda, tables, b, t):
    """``backtrace_nbest`` against its plain version (see
    ``_nbest_walk_inputs``): equal arcs, start states and ok flags, one
    launch a call; the hub's walks take the exact step past the warp's 32
    slots and through arcs no slot holds, with the row starts staged in
    shared memory and (``wide_hub``) read from global memory."""
    plan, bp_arc, bp_slot, nf, state, slot = _nbest_walk_inputs(tables, b, t, cuda)
    before = _build.launches["backtrace_nbest"]
    got = V.nbest_walk(plan, bp_arc, bp_slot, nf, state, slot)
    ref = V.nbest_walk_plain(bp_arc, bp_slot, plan.arc_src, nf, state, slot)
    torch.cuda.synchronize()
    assert _build.launches["backtrace_nbest"] - before == 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    assert bool(got[2].any())
    if tables == "random" and t > 1 and b > 1:  # a lane's walks soon merge: all fail or none
        assert not bool(got[2].all())


def test_decode_nbest_cuda_matches_cpu(cuda):
    g = synth_decode_graph(400, arcs_per_state=4, num_pdfs=30, seed=2)
    am = random_am(30, 2, 13, seed=3)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((6, 25, 13)).astype(np.float32)
    nf = np.array([25, 20, 25, 3, 0, 11], np.int32)
    utts = [f"u{i}" for i in range(6)]
    out = {}
    for dev in ("cpu", cuda):
        dec = Decoder.from_dense_graph(g, am, DecodeOptions(acoustic_scale=0.3), device=dev)
        out[str(dev)] = dec.decode_nbest(utts, feats, nf, nbest=4, keep_arcs=True,
                                         batch_chunk=4)
    for u in utts:
        got, want = out[str(cuda)][u], out["cpu"][u]
        assert [h[2] for h in got] == [h[2] for h in want], u
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], rtol=1e-5)


def _loop_graph():
    """A 40-state chain (self-loops, forward arcs, each arc's pdf its
    destination state) with one arc back from state 30 to state 10, and the
    81 frames' pdfs of a path that takes the back arc twice."""
    s = 40
    src = [x for st in range(s) for x in ([st, st] if st + 1 < s else [st])] + [30]
    dst = [x for st in range(s) for x in ([st, st + 1] if st + 1 < s else [st])] + [10]
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    alpha0 = np.full(s, DC.NEG_INF, np.float32)
    alpha0[0] = 0.0
    final = np.full(s, DC.NEG_INF, np.float32)
    final[-1] = 0.0
    graph = DenseGraph(num_states=s, arc_src=src, arc_dst=dst, arc_tid=dst, arc_pdf=dst,
                       arc_score=np.full(len(src), -0.1, np.float32),
                       arc_oseq=np.zeros(len(src), np.int32), alpha0=alpha0,
                       start_oseq=np.zeros(s, np.int32), final_score=final,
                       final_oseq=np.zeros(s, np.int32), oseqs=[()])
    path = list(range(31)) + list(range(10, 31)) + list(range(10, 40))
    return graph, np.asarray(path[1:])


def _generic_case(case):
    rng = np.random.default_rng(5)
    if case == "back_arc":  # a best path through the back arc, beside a ragged graph
        graphs = [_loop_graph()[0], synth_train_graph(160, 50, rng, back_arcs=2)]
        t_total, nf = 81, [81, 0]
    elif case == "global_arcs":  # 16 bytes an arc beyond 96 KB: rows read through L2
        graphs = [synth_train_graph(2400, 50, rng, back_arcs=1500) for _ in range(3)]
        t_total, nf = 40, [40, 33, 0]
    elif case == "big_alpha":  # alpha and rows beyond 48 KB: the shared-memory opt-in
        graphs = [synth_train_graph(5000, 50, rng, back_arcs=3) for _ in range(2)]
        t_total, nf = 30, [30, 12]
    elif case in ("mid_in", "wide_in"):  # 6 or 15 arcs into a state: past the registers' 4
        graphs = [synth_train_graph(200, 50, rng, back_arcs=1,
                                    fan_in=3 if case == "mid_in" else 12),
                  synth_train_graph(170, 50, rng, back_arcs=2)]
        t_total, nf = 180, [180, 150]
    elif case == "no_ring":  # alpha and row starts near 227 KB: no room for the ring
        graphs = [synth_train_graph(19300, 4000, rng, back_arcs=2) for _ in range(2)]
        t_total, nf = 12, [12, 9]
    elif case == "fan_in":  # 300 arcs into a state: no byte codes, the walk reads bps
        graphs = [synth_train_graph(320, 50, rng, back_arcs=1, fan_in=300),
                  synth_train_graph(160, 50, rng, back_arcs=2)]
        t_total, nf = 170, [170, 170]
    else:
        graphs = [synth_train_graph(int(n), 50, rng, back_arcs=2) for n in (160, 170, 165, 175)]
        t_total, nf = 180, [180, 150, 0, 1]
    return graphs, t_total, np.asarray(nf, np.int32)


GENERIC_CASES = ["ragged", "pruned", "global_arcs", "big_alpha", "back_arc", "mid_in", "wide_in",
                 "fan_in", "no_ring"]


@pytest.mark.parametrize("case", GENERIC_CASES)
def test_generic_aligner_matches_plain(cuda, case):
    """The generic aligner's kernels against their plain versions on the
    same CUDA tensors: bit-equal scores, equal backpointers, codes and arcs,
    one launch of each kernel a call; through the old signatures (the plan
    built in the wrapper, the backtrace walking ``bps``) and through a plan
    built once (``generic_forward`` / ``generic_backtrace``: the codes, the
    staged walk).  The forward takes its in-arcs from registers in
    ``ragged``, ``pruned`` and ``back_arc``, from shared memory in
    ``mid_in``, ``wide_in`` and ``fan_in``, through L2 in ``global_arcs``,
    ``big_alpha`` and ``no_ring``, the last reading its emissions from global
    memory.  In the ``back_arc`` case the loop graph's pdfs win their frames
    by 8, so its best path takes the back arc twice."""
    graphs, t_total, nf_np = _generic_case(case)
    beam = 6.0 if case == "pruned" else 1e9
    p = V.pad_graphs(graphs)
    b = len(graphs)
    rng = np.random.default_rng(6)
    ll_np = rng.standard_normal((b, t_total, max(50, int(p["arc_pdf"].max()) + 1))).astype(
        np.float32)
    if case == "back_arc":
        ll_np[0] = -8.0
        ll_np[0, np.arange(t_total), _loop_graph()[1]] = 0.0
    ll = torch.from_numpy(ll_np).to(cuda)
    nf = torch.from_numpy(nf_np).to(cuda)
    plan = V.generic_plan_to_device(graphs, cuda)
    s = plan.num_states
    small = s <= 512 and plan.max_in_degree <= 4
    assert small == (case in ("ragged", "pruned", "back_arc"))
    # alpha twice, the maxima, the ring and pdf list, the row starts
    ring_fits = 4 * (2 * s + 4) + 20 * plan.pdf_list.shape[1] + 4 * (s + 1) <= 227 * 1024
    assert ring_fits == (case != "no_ring")
    assert (plan.max_in_degree > V.CODE_MAX_DEGREE) == (case == "fan_in")

    def tensor(name, dtype):
        return torch.from_numpy(p[name]).to(cuda, dtype)

    def launches(fn):
        before = dict(_build.launches)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: _build.launches[k] - before[k] for k in before if
                     _build.launches[k] != before[k]}

    (ae_k, bps_k), n = launches(lambda: V.viterbi_forward_batched(
        p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"], p["alpha0"], ll, nf_np, 0.5,
        beam, p["num_states"]))
    assert n == {"generic_forward": 1}
    ae_p, bps_p = V.viterbi_forward_batched_plain(
        tensor("arc_src", torch.int64), tensor("arc_dst", torch.int64),
        tensor("arc_pdf", torch.int64), tensor("arc_score", torch.float32),
        tensor("alpha0", torch.float32), ll, nf, 0.5, float(np.float32(beam)))
    torch.cuda.synchronize()
    assert torch.equal(ae_k, ae_p)
    assert torch.equal(bps_k, bps_p)
    got, n = launches(lambda: V.backtrace_batched_device(p["arc_src"], ae_k, p["final_score"],
                                                         bps_k, nf_np))
    assert n == {"generic_backtrace": 1}
    ref = V.backtrace_batched_plain(tensor("arc_src", torch.int64), ae_k,
                                    tensor("final_score", torch.float32), bps_k, nf)
    for g_, r_ in zip(got, ref):
        assert torch.equal(g_, r_.to(g_.dtype))
    (ae_c, bps_c, codes), n = launches(lambda: V.generic_forward(plan, ll, nf, 0.5, beam))
    assert n == {"generic_forward": 1}
    assert torch.equal(ae_c, ae_p) and torch.equal(bps_c, bps_p)
    want_codes = V.generic_codes_plain(bps_p, plan)
    assert (codes is None) == (want_codes is None) == (case == "fan_in")
    if codes is not None:
        assert torch.equal(codes, want_codes)
    got_c, n = launches(lambda: V.generic_backtrace(plan, ae_c, bps_c, codes, nf))
    assert n == {"generic_backtrace": 1}
    for g_, r_ in zip(got_c, ref):
        assert torch.equal(g_, r_.to(g_.dtype))
    if codes is not None:
        for g_, r_ in zip(got_c, V.generic_backtrace_codes_plain(plan, ae_c, plan.final, codes,
                                                                  nf)):
            assert torch.equal(g_, r_.to(g_.dtype))
    if case == "ragged":
        assert bool(got[1][0]) and not bool(got[1][2])  # a full path; no frames, no path
    if case == "back_arc":
        g, arcs = graphs[0], got[0][:, 0].cpu().numpy()
        assert bool(got[1][0]) and (arcs >= 0).all()
        np.testing.assert_array_equal(g.arc_dst[arcs], _loop_graph()[1])
        assert int((g.arc_dst[arcs] < g.arc_src[arcs]).sum()) == 2


def test_generic_aligner_backtrace_failures(cuda):
    """The staged walk against the plain code-driven backtrace where the
    path meets a 0xFF (held state, ok cleared) in mid-utterance, over 1 to
    1000 frames (up to 13 staged chunks) and a lane with no frames."""
    rng = np.random.default_rng(8)
    graphs = [synth_train_graph(int(n), 50, rng, back_arcs=2) for n in (160, 384, 200, 170)]
    plan = V.generic_plan_to_device(graphs, cuda)
    for t_total, nf_np in ((1, [1, 1, 0, 1]), (1000, [1000, 999, 0, 517])):
        nf = torch.tensor(nf_np, dtype=torch.int32, device=cuda)
        ll = torch.from_numpy(rng.standard_normal((4, t_total, 50), dtype=np.float32)).to(cuda)
        ae, bps, codes = V.generic_forward(plan, ll, nf, 0.5, 1e9)
        arcs = V.generic_backtrace(plan, ae, bps, codes, nf)[0]
        cut = codes.clone()
        for bi in (0, 3):  # a 0xFF at the state the path holds at a middle frame
            ti = nf_np[bi] // 2
            if arcs[ti, bi] >= 0:
                cut[bi, ti, V.plan_arcs(plan)[1][bi, arcs[ti, bi].long()]] = V.NO_ARC
        got = V.generic_backtrace(plan, ae, bps, cut, nf)
        want = V.generic_backtrace_codes_plain(plan, ae, plan.final, cut, nf)
        for g_, r_ in zip(got, want):
            assert torch.equal(g_, r_.to(g_.dtype))
        if t_total > 1:
            assert not bool(got[1][0]) and not bool(got[1][3]) and bool(got[1][1])


def test_generic_aligner_plan_makes_no_sync(cuda):
    """Given a plan, and the frame counts on the card, the forward and the
    backtrace make no host synchronisation."""
    rng = np.random.default_rng(9)
    graphs = [synth_train_graph(int(n), 50, rng, back_arcs=2) for n in (160, 170)]
    plan = V.generic_plan_to_device(graphs, cuda)
    ll = torch.from_numpy(rng.standard_normal((2, 200, 50), dtype=np.float32)).to(cuda)
    nf = torch.tensor([200, 181], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ae, bps, codes = V.generic_forward(plan, ll, nf, 0.5, 1e9)
        out = V.generic_backtrace(plan, ae, bps, codes, nf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(out[1].all())


def test_generic_aligner_kernel_refuses_max_active(cuda):
    graphs, t_total, nf_np = _generic_case("ragged")
    p = V.pad_graphs(graphs)
    ll = torch.zeros((len(graphs), t_total, 50), device=cuda)
    with pytest.raises(NotImplementedError, match="max_active"):
        V.viterbi_forward_batched(p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"],
                                  p["alpha0"], ll, nf_np, 0.5, 8.0, p["num_states"],
                                  max_active=10)



def test_lda_mllt_device_functions_cuda_match_cpu(cuda):
    """Splice, the LDA statistics, the affine projection and the MLLT
    statistics on the card against the same functions on the CPU: splice
    bit-equal; LDA counts and class means (float64 segment sums) rtol 1e-6
    and bit-equal between two card runs, the second moment (fp32 product)
    rtol 1e-5 / atol 1e-3; the projection at the GMM tolerance; G rtol 1e-4
    / atol 1e-3 and beta rtol 1e-6 on a GMM of uneven mixture counts (1-9)
    at 40 dimensions, in one chunk and in chunks."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((3, 200, 13)).astype(np.float32)
    nf = torch.tensor([200, 57, 1], dtype=torch.int32)
    on = {dev: TF.splice_frames_batch(torch.from_numpy(base).to(dev), nf)
          for dev in (cuda, "cpu")}
    assert torch.equal(on[cuda].cpu(), on["cpu"])
    x = {dev: t.reshape(-1, 91) for dev, t in on.items()}
    ids = rng.integers(0, 50, 600)
    w = rng.choice([0.0, 0.3, 1.0], size=600).astype(np.float32)
    got, ref = TL.acc_lda_stats(x[cuda], ids, w, 50), TL.acc_lda_stats(x["cpu"], ids, w, 50)
    again = TL.acc_lda_stats(x[cuda], ids, w, 50)
    for i, (g, r) in enumerate(zip(got, ref)):
        tol = dict(rtol=1e-5, atol=1e-3) if i == 2 else dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g.cpu(), r, **tol)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    mat = rng.standard_normal((40, 92)).astype(np.float32)
    feats = {dev: TL.apply_affine_transform(on[dev], mat) for dev in (cuda, "cpu")}
    torch.testing.assert_close(feats[cuda].cpu(), feats["cpu"], rtol=2e-5, atol=2e-4)
    am = _am(30, 9, 40, seed=8, ragged=True)
    pdf = rng.integers(0, 30, 600)
    pdf = np.where(am.weights[pdf].max(axis=1) > 0, pdf, int(np.argmax(am.weights[:, 0])))
    # frames near their pdf's first mean, on the scale of tests/test_torch_lda_mllt.py
    x40 = (am.means()[pdf, 0] + rng.standard_normal((600, 40))).astype(np.float32)
    fw = rng.choice([0.0, 1.0], size=x40.shape[0]).astype(np.float32)
    g_ref, b_ref = TM.acc_mllt_stats(gmm_kernels.pack_gmm(am, "cpu"), am.means(), am.inv_vars,
                                     x40, pdf, fw)
    for chunk in (None, 128):
        g, beta = TM.acc_mllt_stats(gmm_kernels.pack_gmm(am, cuda), am.means(), am.inv_vars,
                                    x40, pdf, fw, chunk=chunk)
        torch.testing.assert_close(g.cpu(), g_ref, rtol=1e-4, atol=1e-3)
        assert beta == pytest.approx(b_ref, rel=1e-6)


def _segment_stats_float64(gamma, x_acc, pdf, num_pdfs, _plain=gmm_kernels._segment_stats):
    """The plain E-step's per-pdf sums in float64, as K6 sums (the CPU's
    reference run of a stage, in place of its float32 sums)."""
    return _plain(gamma.double(), x_acc.double(), pdf, num_pdfs)


def _keep_card_e_steps(monkeypatch, module) -> list:
    """Wrap ``module.e_step`` to keep each card call's inputs (the model as it
    was then) and the statistics it returned."""
    import copy

    kept, e_step = [], module.e_step

    def keep(am, trans_model, x, tids, weights):
        out = e_step(am, trans_model, x, tids, weights)
        if x.is_cuda:
            kept.append((copy.deepcopy(am), trans_model.tid2pdf, trans_model.tree.num_pdfs,
                         x.cpu(), tids.copy(), weights.copy(), out))
        return out

    monkeypatch.setattr(module, "e_step", keep)
    return kept


def _hold_card_e_steps(kept) -> None:
    """K6's occupancies, first and second moments in each kept card E-step
    against the plain E-step in float64 on the same inputs, at K6's
    tolerance (rtol 1e-5, atol 1e-5 x each accumulator's largest
    magnitude)."""
    assert kept
    for am, tid2pdf, num_pdfs, x, tids, weights, (occ, macc, vacc, _t, _ll) in kept:
        ref = gmm_kernels.acc_gmm_stats_aligned(
            gmm_kernels.pack_gmm(am, "cpu").to(torch.float64), x.double(),
            torch.from_numpy(tid2pdf[tids.reshape(-1)]), num_pdfs,
            torch.from_numpy(weights.reshape(-1)).double())
        for got, want in zip((occ, macc, vacc), ref[:3]):
            want = want.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _tri_inputs(corpus_kind):
    """A monophone model trained by the port on the CPU and its alignments:
    the corpora of ``tests/test_torch_tri.py`` (``mono``) and
    ``tests/test_torch_lda_mllt.py`` (``speakers``)."""
    from voicebridge_tpu_torch.config import LangOptions, MonoTrainOptions
    from voicebridge_tpu_torch.data.lang import prepare_lang
    from voicebridge_tpu_torch.steps.align import align_utterances
    from voicebridge_tpu_torch.steps.train_mono import train_mono

    from synth import LEXICON, SR, make_speaker_corpus

    if corpus_kind == "mono":
        train, _ = make_corpus(num_train=20, num_test=8, seed=11)
        utt2spk = {u: u for u in train}
    else:
        train, _, utt2spk = make_speaker_corpus(num_speakers=4, utts_per_speaker=6,
                                                num_test_per=2, seed=3)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    waves = {u: w for u, (w, _) in train.items()}
    delta = make_features(waves, utt2spk, opts, device="cpu")
    base = make_features(waves, utt2spk, opts, deltas=None, device="cpu")
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    transcripts = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    mono = train_mono(delta, transcripts, lang,
                      MonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                       realign_iters=tuple(range(1, 10))), device="cpu")
    ali = align_utterances(mono.am, mono.trans_model, lang, delta, transcripts,
                           acoustic_scale=0.1, device="cpu")
    return dict(delta=delta, base=base, lang=lang, transcripts=transcripts, mono=mono, ali=ali)


def test_train_tri_cuda_matches_cpu(cuda, monkeypatch):
    """The triphone stage on the card (K2 and the aligner over triphone
    training graphs, K6 at the triphone model's uneven mixture counts)
    against the CPU: the same tree, and models that agree after two EM
    iterations realigned at 2 (as ``tests/test_torch_tri.py`` holds the
    stage to the JAX package; past the second mixup a just-split Gaussian's
    mean moves by float32 differences of its posteriors).  The CPU's run
    sums its E-step in float64, as K6 does, and each of the card's E-steps
    is held to a float64 plain E-step on its own inputs."""
    from voicebridge_tpu_torch.config import TriTrainOptions
    from voicebridge_tpu_torch.steps import train_tri as TT

    s = _tri_inputs("mono")
    opts = TriTrainOptions(num_iters=2, num_leaves=100, totgauss=300, max_iter_inc=8,
                           realign_iters=(2,))
    args = (s["delta"], s["transcripts"], s["ali"], s["lang"], opts)
    with monkeypatch.context() as m:
        m.setattr(gmm_kernels, "_segment_stats", _segment_stats_float64)
        want = TT.train_tri(*args, prev_trans_model=s["mono"].trans_model, device="cpu")
    kept = _keep_card_e_steps(monkeypatch, TT)
    before = dict(_build.launches)
    got = TT.train_tri(*args, prev_trans_model=s["mono"].trans_model, device=cuda)
    launched = {k: n - before[k] for k, n in _build.launches.items()}
    assert launched["gmm_loglikes"] > 0 and launched["gmm_stats"] > 0
    assert launched["align_forward"] + launched["generic_forward"] > 0
    assert got.tree.nodes == want.tree.nodes
    _hold_card_e_steps(kept)
    assert_models_close(got, want)


def test_train_lda_mllt_cuda_matches_cpu(cuda, monkeypatch):
    """The LDA+MLLT stage on the card against the CPU, on equal inputs where
    the stage solves a host problem from the device's statistics.  The
    corpus has fewer live classes than 40, so LDA rows past the
    between-class rank are any whitened null directions: the card's LDA
    estimate is held to the CPU's on the rows the statistics define (up to
    sign) and the stage goes on with the CPU's matrix.  The card's MLLT
    statistics (D = 40) are held to the CPU's (G rtol 1e-4, atol 1e-3 scaled
    with its largest entry over 1e3; beta rtol 1e-6) and the stage goes on
    with the CPU's MLLT matrix: est_mllt stops at a relative objective change
    of 1e-7, so nearly equal statistics give matrices whose difference the
    model's variances amplify.  Then the tree, the projection, one EM
    iteration (K6, held to a float64 plain E-step on its own inputs) and the
    M-step are held as the monophone models are; the CPU's run sums its
    E-step in float64, as K6 does.  ``test_train_tri_cuda_matches_cpu``
    holds realignment on the card."""
    from voicebridge_tpu_torch.config import TriTrainOptions
    from voicebridge_tpu_torch.steps import train_lda_mllt as TLM

    s = _tri_inputs("speakers")
    opts = TriTrainOptions(num_iters=1, num_leaves=100, totgauss=300, max_iter_inc=6,
                           realign_iters=(), mllt_iters=(1,))
    args = (s["base"], s["transcripts"], s["ali"], s["lang"], opts)
    captured = {"lda": [], "mllt": []}
    estimate, solve = TLM.estimate_lda, TLM.est_mllt

    def keep_lda(*a):
        captured["lda"].append((a, estimate(*a)))
        return captured["lda"][-1][1]

    def keep_mllt(g, beta):
        captured["mllt"].append(((g, beta), solve(g, beta)))
        return captured["mllt"][-1][1]

    with monkeypatch.context() as m:
        m.setattr(TLM, "estimate_lda", keep_lda)
        m.setattr(TLM, "est_mllt", keep_mllt)
        m.setattr(gmm_kernels, "_segment_stats", _segment_stats_float64)
        want, want_mat = TLM.train_lda_mllt(*args, prev_trans_model=s["mono"].trans_model,
                                            device="cpu")
    (stats_cpu, lda_cpu), = captured["lda"]
    ((g_cpu, beta_cpu), m_cpu), = captured["mllt"]

    def hold_lda(counts, mean_acc, scatter, dim, wcf):
        mat = estimate(counts, mean_acc, scatter, dim, wcf)
        r = min(int((counts > 0).sum()) - 1, dim)
        sign = np.sign(np.sum(mat[:, :-1] * lda_cpu[:, :-1], axis=1))
        np.testing.assert_allclose((mat * sign[:, None])[:r], lda_cpu[:r], rtol=1e-4,
                                   atol=1e-4 * np.abs(lda_cpu).max())
        np.testing.assert_allclose(counts, stats_cpu[0], rtol=1e-6)
        return lda_cpu

    def hold_mllt(g, beta):
        np.testing.assert_allclose(g, g_cpu, rtol=1e-4,
                                   atol=1e-3 * max(1.0, float(np.abs(g_cpu).max()) / 1e3))
        assert beta == pytest.approx(beta_cpu, rel=1e-6)
        return m_cpu

    monkeypatch.setattr(TLM, "estimate_lda", hold_lda)
    monkeypatch.setattr(TLM, "est_mllt", hold_mllt)
    kept = _keep_card_e_steps(monkeypatch, TLM)
    before = dict(_build.launches)
    got, mat = TLM.train_lda_mllt(*args, prev_trans_model=s["mono"].trans_model, device=cuda)
    launched = {k: n - before[k] for k, n in _build.launches.items()}
    assert launched["gmm_stats"] > 0  # no realignment in one iteration: no K2 launch
    np.testing.assert_array_equal(mat, want_mat)
    assert got.tree.nodes == want.tree.nodes
    _hold_card_e_steps(kept)
    assert_models_close(got, want)


def test_fmllr_device_functions_cuda_match_float64(cuda):
    """The fMLLR statistics on the card against their float64 plain version
    (``testing.fmllr_stats_float64``) at D = 40 on a GMM of uneven mixture
    counts (1-9), rows of weight 0 and three speakers: beta rtol 1e-6, K and
    G rtol 1e-4 with an atol of 1e-6 times each one's largest entry, in one
    chunk and in chunks of 512 rows; two card runs give the same bits.
    ``apply_fmllr_batch`` against float64 at rtol 1e-6 / atol 1e-5."""
    from voicebridge_tpu_torch.testing import fmllr_stats_float64
    from voicebridge_tpu_torch.transforms import fmllr as TFM

    rng = np.random.default_rng(9)
    am = _am(30, 9, 40, seed=8, ragged=True)
    n = 3000
    pdf = rng.integers(0, 30, n)
    pdf = np.where(am.weights[pdf].max(axis=1) > 0, pdf, int(np.argmax(am.weights[:, 0])))
    x = torch.from_numpy((am.means()[pdf, 0] + rng.standard_normal((n, 40))).astype(np.float32))
    w = rng.choice([0.0, 0.3, 1.0], size=n).astype(np.float32)
    spk = rng.choice([0, 1, 2], size=n, p=[0.5, 0.4, 0.1])
    ref = fmllr_stats_float64(am, x.to(cuda), pdf, w, spk, 3)
    params = gmm_kernels.pack_gmm(am, cuda)
    runs = [TFM.acc_fmllr_stats(params, am.means(), am.inv_vars, x, pdf, w, spk, 3, chunk=c,
                                device=cuda) for c in (None, None, 512)]
    for got in runs:
        for i, (g, r) in enumerate(zip(got, ref)):
            tol = dict(rtol=1e-6, atol=0.0) if i == 0 else dict(rtol=1e-4, atol=1e-6 * float(
                r.abs().max()))
            torch.testing.assert_close(g.double(), r, **tol)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    feats = torch.from_numpy(3 * rng.standard_normal((4, 50, 40)).astype(np.float32))
    eye = np.concatenate([np.eye(40), np.zeros((40, 1))], axis=1)
    trans = (eye + 0.1 * rng.standard_normal((3, 40, 41))).astype(np.float32)
    s_utt = np.array([2, 0, 1, 0])
    got = TFM.apply_fmllr_batch(feats, trans, s_utt, device=cuda)
    t64 = torch.from_numpy(trans).double()[torch.from_numpy(s_utt)]
    want = feats.double() @ t64[:, :, :-1].transpose(1, 2) + t64[:, None, :, -1]
    torch.testing.assert_close(got.cpu().double(), want, rtol=1e-6, atol=1e-5)


def test_decode_fmllr_cuda_gives_the_jax_words(cuda):
    """The committed JAX-trained SAT model through ``decode_fmllr`` on the
    card (features made on the card): the JAX package's words for the 8 test
    utterances, scores within rtol 1e-4, final transforms within an atol of
    1e-2 times their largest entry (``tests/test_torch_sat.py`` says why),
    and K2, K3 and K5 launched."""
    from voicebridge_tpu_torch.config import FmllrDecodeOptions, LangOptions
    from voicebridge_tpu_torch.data.lang import prepare_lang
    from voicebridge_tpu_torch.steps.decode_fmllr import decode_fmllr
    from voicebridge_tpu_torch.steps.make_feats import pad_features
    from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats
    from voicebridge_tpu_torch.testing import load_synth_sat

    from synth import LEXICON, make_speaker_corpus

    m = load_synth_sat()
    train, test, utt2spk = make_speaker_corpus(**m.corpus)
    waves = {u: w for u, (w, _) in {**train, **test}.items()}
    base = make_features(waves, utt2spk,
                         MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0)),
                         deltas=None, device=cuda)
    feats = lda_decode_feats({u: base[u] for u in test}, m.final_mat, device=cuda)
    utts = sorted(feats)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    before = dict(_build.launches)
    res, trans = decode_fmllr(m.hclg, m.trans_model, m.am, m.alimdl, lang, utts,
                              *pad_features(feats, utts), utt2spk,
                              FmllrDecodeOptions(beam=1e9, first_beam=1e9,
                                                 fmllr_min_count=50.0), device=cuda)
    launched = {k: n - before[k] for k, n in _build.launches.items()}
    assert all(launched[k] > 0 for k in ("gmm_loglikes", "viterbi_step",
                                         "viterbi_step_backward", "lattice_fb"))
    assert {r.utt: [m.words.sym(w) for w in r.words] for r in res} == m.hyps
    np.testing.assert_allclose([r.score for r in res], [m.scores[u] for u in utts], rtol=1e-4)
    want = np.stack([m.transforms[s] for s in sorted(m.transforms)])
    np.testing.assert_allclose(trans, want, rtol=0, atol=1e-2 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The remaining frontends and speaker adaptation
# ---------------------------------------------------------------------------


def _float64_tables(tables):
    return dataclasses.replace(tables, **{f: getattr(tables, f).double()
                                          for f in ("window", "mel_t", "dct_t", "lifter")})


@pytest.mark.parametrize("n_fft", [256, 400, 512, 1024])
@pytest.mark.parametrize("htk_mode", [False, True])
def test_mfcc_mel_power_matches_float64(cuda, n_fft, htk_mode):
    """K1's ``mel_power`` rows (mel energies, floored at 1.0 in HTK mode
    only, then the log energy) against the plain version in float64, the
    energies compared as logs floored at FLT_EPS with the MFCC tolerance (a
    mel bin far below the frame's power carries the FFT's rounding of the
    whole frame); counted as ``mfcc_mel_power``, not ``mfcc_frames``.  PLP
    through the kernel against its plain version in float64, same
    tolerance."""
    from voicebridge_tpu_torch.config import PlpOptions

    opts = _mfcc_opts(n_fft, "htk_mode" if htk_mode else "default")
    fo = opts.frame_opts
    tables = TF.MfccTables.build(opts, "mel_power", cuda)
    frames = torch.from_numpy(_frames(fo.samp_freq, fo.window_size, 333, seed=3)).to(cuda)
    frames[7] = 0.0  # a silent frame: zero energies, or 1.0 in HTK mode
    before = dict(_build.launches)
    got = mfcc_kernel.mfcc_frames(frames, tables)
    torch.cuda.synchronize()
    assert _build.launches["mfcc_mel_power"] == before["mfcc_mel_power"] + 1
    assert _build.launches["mfcc_frames"] == before["mfcc_frames"]
    ref = TF.mfcc_from_frames(frames.double(), _float64_tables(tables))
    assert got.shape == ref.shape == (333, 24)
    eps = float(np.finfo(np.float32).eps)
    torch.testing.assert_close(torch.log(got[:, :-1].double().clamp_min(eps)),
                               torch.log(ref[:, :-1].clamp_min(eps)), rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(got[:, -1].double(), ref[:, -1], rtol=2e-4, atol=2e-3)
    assert float(got[7, :-1].min()) == (1.0 if htk_mode else 0.0)
    plp_opts = PlpOptions(frame_opts=fo, mel_opts=opts.mel_opts)
    ptab = TF.PlpTables.build(plp_opts, cuda)
    p64 = TF.PlpTables(plp_opts, _float64_tables(ptab.k1), ptab.eql.double(),
                       ptab.idft.double(), ptab.lifter.double())
    torch.testing.assert_close(TF.plp_tail(mfcc_kernel.mfcc_frames(frames, ptab.k1), ptab)
                               .double(), TF.plp_from_frames(frames.double(), p64),
                               rtol=2e-4, atol=2e-3)


def test_frontend_extractors_cuda_match_cpu(cuda):
    """``PlpExtractor``, ``FbankExtractor`` (with its own energy column) and
    ``make_features(pitch=True)`` on the card against the CPU's plain
    versions with the MFCC tolerance; ``SpectrogramExtractor`` as powers,
    rtol 2e-4 plus 1e-5 of the frame's largest bin: a float32 FFT's rounding
    is on the scale of the whole frame's power, so the log of a bin far
    below it (the DC bin after DC removal) is ill-conditioned."""
    from voicebridge_tpu_torch.config import PlpOptions

    rng = np.random.default_rng(4)
    waves = np.stack([_frames(16000.0, 16000, 1, seed=s)[0] for s in range(3)])
    lens = np.array([16000, 12000, 9000])
    fo = FrameOptions(dither=0.0)
    nf = fo.num_frames(16000)
    for ext_cls, kw in ((TF.PlpExtractor, dict(opts=PlpOptions(frame_opts=fo))),
                        (TF.FbankExtractor, dict(opts=MfccOptions(frame_opts=fo),
                                                 use_energy=True)),
                        (TF.SpectrogramExtractor, dict(opts=MfccOptions(frame_opts=fo)))):
        got, cg = ext_cls(**kw, device=cuda).batched(waves, lens, nf)
        want, cw = ext_cls(**kw, device="cpu").batched(waves, lens, nf)
        assert torch.equal(cg.cpu(), cw)
        for i, n in enumerate(cw.tolist()):
            g, w = got[i, :n].cpu().double(), want[i, :n].double()
            if ext_cls is TF.SpectrogramExtractor:
                g, w = g.exp(), w.exp()
                assert ((g - w).abs() <= 2e-4 * w + 1e-5 * w.amax(1, keepdim=True)).all()
            else:
                torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-3)
    utts = {f"u{i}": (rng.standard_normal(8000) * 300 + 4000 * np.sin(
        2 * np.pi * 140 * np.arange(8000) / 8000.0)).astype(np.float32) for i in range(2)}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=0.0))
    got = make_features(utts, {u: "s" for u in utts}, opts, device=cuda, pitch=True)
    want = make_features(utts, {u: "s" for u in utts}, opts, device="cpu", pitch=True)
    for u in utts:
        assert got[u].shape == want[u].shape == (want[u].shape[0], 48)
        torch.testing.assert_close(got[u].cpu(), want[u], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("num_classes", [1, 2, 8])
def test_regtree_fmllr_loglikes_k2_per_class(cuda, num_classes):
    """``regtree_fmllr_loglikes`` on the card: one K2 launch per regression
    class holding Gaussians, laid out from the live Gaussians of that class
    alone, against the JAX formulation (``regtree_fmllr_loglikes_plain``) in
    float64 with the GMM tolerance; a pdf with no active Gaussian comes out
    -inf, not about -1e30."""
    from voicebridge_tpu_torch.transforms import regtree as TR

    rng = np.random.default_rng(num_classes)
    am = _am(40, 5, 13, seed=3, ragged=True)
    tree = TR.build_regression_tree(am.means(), am.weights, 8)
    bclass = tree.bclass_of.copy()
    bclass[5] = -1
    eye = np.concatenate([np.eye(13), np.zeros((13, 1))], axis=1)
    trans = (eye + 0.05 * rng.standard_normal((num_classes, 13, 14))).astype(np.float32)
    l2c = rng.integers(0, num_classes, 8).astype(np.int32)
    l2c[:num_classes] = np.arange(num_classes)
    x = torch.from_numpy((am.means()[rng.integers(0, 40, 700), 0]
                          + rng.standard_normal((700, 13))).astype(np.float32))
    params = gmm_kernels.pack_gmm(am, cuda)
    before = _build.launches["gmm_loglikes"]
    with P.recording():
        got = TR.regtree_fmllr_loglikes(params, x.to(cuda), trans, l2c, bclass)
    torch.cuda.synchronize()
    assert _build.launches["gmm_loglikes"] == before + num_classes
    assert P.session().counters["gmm.live"] == 700 * int((bclass >= 0).sum())
    ref = TR.regtree_fmllr_loglikes_plain(params, x.to(cuda).double(), trans, l2c, bclass)
    assert torch.isneginf(got[:, 5]).all() and torch.isneginf(ref[:, 5]).all()
    keep = torch.arange(40, device=cuda) != 5
    torch.testing.assert_close(got[:, keep].double(), ref[:, keep], rtol=2e-5, atol=2e-4)


def test_acc_regtree_stats_cuda_match_float64(cuda):
    """``acc_regtree_mllr_stats`` through K6 against the plain version in
    float64 (rtol 1e-5, atol 1e-5 times the largest entry), and
    ``acc_regtree_fmllr_stats`` on the card against the CPU's (1e-6 of the
    largest entry), in one chunk and in chunks of 512 rows."""
    from voicebridge_tpu_torch.transforms import regtree as TR

    rng = np.random.default_rng(12)
    am = _am(30, 4, 13, seed=5, ragged=False)
    tree = TR.build_regression_tree(am.means(), am.weights, 4)
    n = 3000
    pdf = rng.integers(0, 30, n).astype(np.int32)
    x = (am.means()[pdf, 0] + rng.standard_normal((n, 13))).astype(np.float32)
    w = rng.choice([0.0, 0.5, 1.0], size=n).astype(np.float32)
    params = gmm_kernels.pack_gmm(am, cuda)
    before = _build.launches["gmm_stats"]
    occ, xbar = TR.acc_regtree_mllr_stats(params, x, pdf, w)
    assert _build.launches["gmm_stats"] == before + 1
    p64 = params.to(torch.float64)
    ref = gmm_kernels.acc_gmm_stats_aligned(p64, torch.from_numpy(x).to(cuda).double(),
                                            torch.from_numpy(pdf).to(cuda), 30,
                                            torch.from_numpy(w).to(cuda).double())
    for g, r in ((occ, ref[0]), (xbar, ref[1])):
        torch.testing.assert_close(torch.from_numpy(g).double(), r.cpu(), rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))
    cpu = TR.acc_regtree_fmllr_stats(gmm_kernels.pack_gmm(am, "cpu"), am.means(), am.inv_vars,
                                     x, pdf, w, tree.bclass_of, 4, device="cpu")
    for chunk in (None, 512):
        got = TR.acc_regtree_fmllr_stats(params, am.means(), am.inv_vars, x, pdf, w,
                                         tree.bclass_of, 4, chunk=chunk, device=cuda)
        for g, r in zip(got, cpu):
            torch.testing.assert_close(g.cpu(), r, rtol=0, atol=1e-6 * float(r.abs().max()))


def test_full_gmm_cuda_matches_float64(cuda):
    """``loglikes_full`` across chunk boundaries (None, 100 and 1 frames a
    chunk) and ``acc_full_stats`` (a chunk smaller than a pdf's frames)
    against float64 versions of the same functions: the GMM tolerance for
    log-likelihoods, rtol 1e-5 with 1e-5 of the largest entry for
    statistics."""
    from voicebridge_tpu_torch.models import full_gmm as TG

    rng = np.random.default_rng(13)
    p, m, d = 3, 16, 8
    w = rng.random((p, m)) + 0.2
    w[2, 5] = 0.0
    a = rng.standard_normal((p, m, d, d)) * 0.3
    ic = np.linalg.inv(np.einsum("pmde,pmfe->pmdf", a, a) + np.eye(d))
    g = TG.FullGmm(w / w.sum(1, keepdims=True), rng.standard_normal((p, m, d)), ic)
    x = torch.from_numpy(rng.standard_normal((517, d)).astype(np.float32))
    pdf = rng.integers(0, p, 517)
    packed = TG.pack_full_gmm(g, cuda)
    p64 = {k: v.double() for k, v in packed.items()}
    ref = TG.loglikes_full(p64, x.to(cuda).double())
    for chunk in (None, 100, 1):
        got = TG.loglikes_full(packed, x.to(cuda), chunk=chunk)
        torch.testing.assert_close(got.double(), ref, rtol=2e-5, atol=2e-4)
    ref = TG.acc_full_stats(p64, x.to(cuda).double(), pdf, p)
    for chunk in (None, 64):
        got = TG.acc_full_stats(packed, x.to(cuda), pdf, p, chunk=chunk)
        for a_, r in zip(got, ref):
            torch.testing.assert_close(a_.double(), r, rtol=1e-5,
                                       atol=1e-5 * float(r.abs().max()))


# ---------------------------------------------------------------------------
# The last slice: TF32 guard, lane-major lattice FB, sharded E-step
# ---------------------------------------------------------------------------


def test_tf32_high_gives_the_ieee_results(cuda):
    """With ``torch.set_float32_matmul_precision("high")`` set by the caller
    the deltas, the LDA decode features and the fMLLR statistics equal,
    bit for bit, the same calls with TF32 off; the caller's setting reads
    again after each call."""
    from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats
    from voicebridge_tpu_torch.transforms import fmllr as TFM

    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal((6, 300, 13)).astype(np.float32)).to(cuda)
    nf = torch.tensor([300, 250, 1, 300, 120, 299])
    by_utt = {f"u{i}": base[i, : int(n)] for i, n in enumerate(nf)}
    mat = rng.standard_normal((40, 92)).astype(np.float32)
    am = _am(30, 4, 40, seed=3, ragged=False)
    n = 4000
    x = torch.from_numpy(rng.standard_normal((n, 40)).astype(np.float32))
    pdf, spk = rng.integers(0, 30, n), rng.integers(0, 3, n)
    params = gmm_kernels.pack_gmm(am, cuda)
    calls = [lambda: TF.add_deltas_batch(base, nf),
             lambda: torch.cat(list(lda_decode_feats(by_utt, mat, device=cuda).values())),
             lambda: torch.cat([t.reshape(-1) for t in TFM.acc_fmllr_stats(
                 params, am.means(), am.inv_vars, x, pdf, np.ones(n, np.float32), spk, 3,
                 device=cuda)])]
    for call in calls:
        try:
            torch.set_float32_matmul_precision("high")
            under = call()
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision("highest")
        assert torch.equal(under, call())


def _lane_inputs(num_states, lanes, frames, seed, ties=False, hub=0):
    g = (synth_hub_graph(num_states, hub, num_pdfs=20, seed=seed) if hub else
         synth_decode_graph(num_states, arcs_per_state=8, num_pdfs=20, seed=seed))
    ll = np.random.default_rng(seed).standard_normal((lanes, frames, 20)) * 3 - 10
    if ties:  # whole-number scores: many states tie, at the k-th value too
        g = g._replace(arc_score=np.round(g.arc_score).astype(np.float32))
        ll = np.round(ll)
    return g, torch.from_numpy(ll.astype(np.float32))


def _lane_kernels_per_call(fn) -> int:
    """The ``lattice_lane.cu`` kernels one call of ``fn`` runs on the device
    (torch.profiler), or -1 where the profiler shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return -1
    return sum("lane_forward_kernel" in n or "lane_backward_kernel" in n for n in dev)


@pytest.mark.parametrize("case", ["exact", "beam", "max_active", "max_active_ties", "window_t",
                                  "window_1", "big", "lanes_130", "no_arcs_hub",
                                  "max_active_ties_groups"])
def test_lattice_lane_kernel_matches_plain(cuda, case):
    """``lattice_lane.cu`` against its plain version on the card: the packed
    survivor bytes, total_best, alpha_at_end and use_final equal, at exact
    search, a finite beam, max_active (with ties at the k-th score), windows
    of 1 frame and longer than T, lanes of no frame and of one, 3,000
    states (a radix select over more states than a block's threads), 130
    lanes (two lane groups, not a multiple of 4: masked scalar loads), a
    graph with states of no in-arcs and of no out-arcs and a hub of about
    5,000 in- and 5,000 out-arcs appended out of source order, and
    max_active with ties across the two lane groups.  Each call launches 3
    windows' worth of ``lattice_lane`` (one launch per window and pass) and,
    where the profiler shows device activity, one device kernel for each."""
    states, lanes, frames, beam, max_active, window, ties, hub = {
        "exact": (300, 5, 40, 1e9, 0, 16, False, 0),
        "beam": (300, 5, 40, 9.0, 0, 16, False, 0),
        "max_active": (300, 5, 40, 1e9, 37, 16, False, 0),
        "max_active_ties": (300, 5, 40, 1e9, 37, 16, True, 0),
        "window_t": (300, 5, 40, 12.0, 20, 64, False, 0),
        "window_1": (200, 3, 12, 1e9, 0, 1, False, 0),
        "big": (3000, 4, 30, 14.0, 500, 8, True, 0),
        "lanes_130": (300, 130, 24, 1e9, 0, 16, False, 0),
        "no_arcs_hub": (6000, 6, 20, 1e9, 0, 8, False, 5000),
        "max_active_ties_groups": (300, 130, 24, 1e9, 37, 16, True, 0)}[case]
    g, ll = _lane_inputs(states, lanes, frames, seed=len(case), ties=ties, hub=hub)
    nf = np.resize(np.array([frames, frames - 7, 0, 1, frames, 5], np.int32), lanes)
    if lanes > 128:  # lanes alike across the two groups (the ties are shared)
        ll[128:] = ll[:lanes - 128]
        nf[128:] = nf[:lanes - 128]
    plan = LAT.lane_plan_to_device(g, LAT.build_dst_plan(g), LAT.build_src_plan(g), cuda)
    x = ll.to(cuda)
    windows = -(-frames // window)

    def kernel():
        return LAT.lattice_forward_backward_packed(plan, x, nf, 1 / 13, beam, 6.0, max_active,
                                                   window)

    _build.launches["lattice_lane"] = 0
    got = kernel()
    assert _build.launches["lattice_lane"] == 3 * windows
    want = LAT.lattice_forward_backward_packed(
        plan, x, nf, 1 / 13, beam, 6.0, max_active, window,
        steps=(LAT.lane_forward_plain, LAT.lane_backward_plain))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0
    if lanes > 128:  # the second group's lanes repeat the first group's
        assert torch.equal(got[0][:, 128:], got[0][:, :lanes - 128])
        assert torch.equal(got[1][128:], got[1][:lanes - 128])
    kernels = _lane_kernels_per_call(kernel)
    assert kernels in (-1, 3 * windows)


def test_sharded_estep_nccl_world1_matches_unsharded(cuda):
    """``em_estep_sharded`` and ``em_estep_sharded_banded`` at world size 1
    over NCCL (a group on an in-process store) against the unsharded
    aligners and E-step sums on the card: alignments bit-equal, K6's sums
    within rtol 1e-5, the transition counts within rtol 1e-9."""
    import torch.distributed as dist

    import torch_parallel_worker as W
    from voicebridge_tpu_torch.parallel import mesh as M

    s = W.build_setup()
    p = s["padded"]
    params = gmm_kernels.pack_gmm(s["am"], cuda)
    data = (s["feats"], s["nf"], s["tids"], s["pdf_ids"], s["weights"])
    ll = gmm_kernel.loglikes_batch(torch.from_numpy(s["feats"]).to(cuda), params)
    x = torch.from_numpy(s["feats"].reshape(-1, W.DIM)).to(cuda)
    w = torch.ones(x.shape[0], device=cuda)
    sums = gmm_kernels.acc_gmm_stats_sums(params, x, x, s["pdf_ids"].reshape(-1),
                                          s["tree"].num_pdfs, w)
    tst = gmm_kernels.transition_sums(torch.from_numpy(s["tids"].reshape(-1)).to(cuda),
                                      s["tm"].num_transition_ids, w)
    band = AB.build_band_plan(s["graphs"])
    try:
        mesh = M.make_mesh(devices=cuda)
        assert mesh.backend == "nccl" and mesh.shape[M.DATA_AXIS] == 1
        res = M.em_estep_sharded(mesh, p["num_states"], s["tree"].num_pdfs,
                                 s["tm"].num_transition_ids)(
            params, p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"], p["alpha0"],
            *data, 0.1)
        res_b = M.em_estep_sharded_banded(mesh, s["tree"].num_pdfs,
                                          s["tm"].num_transition_ids, band.offsets)(
            params, band.W, band.pdf, band.alpha0, *data, 0.1)
    finally:
        dist.destroy_process_group()
    ae, bps = V.viterbi_forward_batched(p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"],
                                        p["alpha0"], ll, s["nf"], 0.1, 1e9, p["num_states"])
    bdev = AB.plan_to_device(band, cuda)
    ae_b, bps_b = AB.viterbi_forward_banded(bdev.W, bdev.pdf, bdev.alpha0, ll,
                                            torch.from_numpy(s["nf"]).to(cuda), 0.1, bdev.offsets)
    assert torch.equal(res[0], ae) and torch.equal(res[1], bps)
    assert torch.equal(res_b[0], ae_b) and torch.equal(res_b[1], bps_b)
    for r in (res, res_b):
        for got, want in zip(r[2:5], sums[:3]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
        torch.testing.assert_close(r[5], tst, rtol=1e-9, atol=0.0)
        torch.testing.assert_close(r[6], sums[3], rtol=1e-5, atol=0.0)

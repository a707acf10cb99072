"""The port's CUDA kernels against their plain PyTorch versions on the same
CUDA tensors, at small shapes and over the options ``chip_smoke.py`` does
not reach (fbank rows, energy and window options, wide feature dims, ragged
mixtures, int16 backpointers, the recompute decode; for the aligner K4
ragged and empty utterances, a failed utterance and a band matrix W too
large for shared memory; for the E-step K6 a pdf holding most frames,
zero-weight frames and two different feature arrays).  They need an NVIDIA
GPU and nvcc, and skip without one:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import FrameOptions, MelOptions, MfccOptions
from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.ops import align_band as AB
from voicebridge_tpu_torch.ops import decode_core as DC
from voicebridge_tpu_torch.ops import features as TF
from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel, mfcc_kernel
from voicebridge_tpu_torch.ops.graph import DenseGraph
from voicebridge_tpu_torch.testing import synth_decode_graph, synth_train_graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _frames(sr, n_frames, seed):
    rng = np.random.default_rng(seed)
    ws = int(sr * 0.025)
    t = np.arange(ws) / sr
    base = 3000 * np.sin(2 * np.pi * rng.uniform(100, 1500, (n_frames, 1)) * t)
    return (base + 80 * rng.standard_normal((n_frames, ws))).astype(np.float32)


@pytest.mark.parametrize("sr", [8000.0, 16000.0])
@pytest.mark.parametrize("variant", ["default", "fbank", "no_dc_no_preemph",
                                     "windowed_energy", "htk_mode", "hamming"])
def test_mfcc_kernel_matches_plain(cuda, sr, variant):
    fo = dict(samp_freq=sr, dither=0.0)
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
    opts = MfccOptions(frame_opts=FrameOptions(**fo), mel_opts=MelOptions(**mo), **kw)
    tables = TF.MfccTables.build(opts, variant == "fbank", cuda)
    frames = torch.from_numpy(_frames(sr, 333, seed=1)).to(cuda)
    got = mfcc_kernel.mfcc_frames(frames, tables)
    ref = TF.mfcc_from_frames(frames, tables)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (333, tables.out_cols)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-3)


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


@pytest.mark.parametrize("num_pdfs,max_mix,dim,n,ragged", [
    (37, 5, 13, 300, False), (21, 7, 11, 64, True), (130, 3, 39, 1000, False),
    (65, 2, 80, 129, False)])  # dim 80: 83 KB of shared memory
def test_gmm_kernel_matches_plain(cuda, num_pdfs, max_mix, dim, n, ragged):
    am = _am(num_pdfs, max_mix, dim, seed=dim, ragged=ragged)
    w = convert.kernel_params_from_am(am, cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((n, dim))
                         .astype(np.float32)).to(cuda)
    got = gmm_kernel.loglikes(x, w)
    ref = gmm_kernels.loglikes(convert.twin_params_from_kernel(w), x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-4)


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


@pytest.mark.parametrize("which", ["packed", "int16"])
def test_viterbi_step_matches_plain(cuda, which):
    graph = synth_decode_graph(700, num_pdfs=40) if which == "packed" else _hub_graph(3)
    plan = DC.build_emit_plan(graph, d=4)
    assert plan.packed == (which == "packed")
    dev = DC.plan_to_device(plan, cuda)
    b, frames = 40, 6
    rng = np.random.default_rng(5)
    ll = torch.from_numpy((rng.standard_normal((frames, 40, b)) * 5 - 30)
                          .astype(np.float32)).to(cuda)
    nf = torch.from_numpy(rng.integers(0, frames + 1, b).astype(np.int32)).to(cuda)
    s1 = plan.num_states + 1
    alpha0 = np.concatenate([graph.alpha0[plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    a_k = a_p = torch.from_numpy(alpha0).to(cuda)[:, None].expand(s1, b).contiguous()
    e_k = torch.full_like(a_k, DC.NEG_INF)
    e_p = e_k.clone()
    dtype = torch.uint8 if plan.packed else torch.int16
    for t in range(frames):
        bp_k = torch.empty((s1, b), dtype=dtype, device=cuda)
        bp_p = torch.empty_like(bp_k)
        a_k, e_k = DC.viterbi_step(a_k, e_k, ll[t], dev, nf, t, 0.25, plan.rspec,
                                   plan.packed, bp_k)
        a_p, e_p = DC.viterbi_step_plain(a_p, e_p, ll[t], dev, nf, t, 0.25, plan.rspec,
                                         plan.packed, bp_p)
        torch.cuda.synchronize()
        assert torch.equal(a_k, a_p) and torch.equal(e_k, e_p), f"frame {t}"
        assert torch.equal(bp_k, bp_p), f"frame {t}"


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
    got = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, cuda),
                              torch.from_numpy(ll).to(cuda), nf, 0.5, bp_bytes_budget=budget)
    ref = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, "cpu"),
                              torch.from_numpy(ll), nf, 0.5, bp_bytes_budget=budget)
    assert got == ref


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


@pytest.mark.parametrize("case", ["skew", "zero_weights", "twofeats"])
def test_gmm_stats_matches_plain(cuda, case):
    """K6 against the plain version: rtol 1e-5, atol 1e-5 x the largest
    magnitude of each accumulator (float32 scores and posteriors in another
    order; the kernel sums in float64)."""
    rng = np.random.default_rng(11)
    am = _am(40, 4, 13, seed=3, ragged=case == "twofeats")
    w = convert.kernel_params_from_am(am, cuda)
    n = 5000
    x_post = rng.standard_normal((n, 13)).astype(np.float32)
    x_acc = rng.standard_normal((n, 13)).astype(np.float32) if case == "twofeats" else x_post
    pdf = rng.integers(0, 40, n).astype(np.int32)
    if case == "skew":
        pdf[rng.random(n) < 0.8] = 5  # 4000 frames: 16 blocks of one pdf
    if case == "twofeats":  # aligned pdfs keep at least one active component
        pdf = np.where(am.weights[pdf].max(axis=1) > 0, pdf, int(np.argmax(am.weights[:, 0])))
    weights = rng.random(n).astype(np.float32)
    if case == "zero_weights":
        weights[rng.random(n) < 0.4] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in (x_post, x_acc, pdf, weights)]
    got = gmm_stats_kernel.acc_stats(w, *args, 40)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(convert.twin_params_from_kernel(w),
                                                     *args[:3], 40, args[3])
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        r = r.double()
        atol = 1e-5 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    again = gmm_stats_kernel.acc_stats(w, *args, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic

"""Smoke run of the PyTorch port (voicebridge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero):

1. Requires CUDA; turns TF32 off for matmul and cuDNN; prints the card's
   name and power limit (nvidia-smi).
2. Builds the five CUDA sources from ``voicebridge_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the compiler's
   register/shared-memory report.
3. Holds each kernel against its plain PyTorch version on the card at the
   full-width shapes, and times both with CUDA events:
   K1 MFCC frames (128 x 10 s of 16 kHz audio), K2 GMM log-likelihoods
   (128k frames x 2000 pdfs x 5 Gaussians x 39 dims), K3 Viterbi frame steps
   (60k-state / 480k-arc graph, B = 128), K4 banded alignment forward and
   backtrace (192 utterances x 400 frames, 384-state training graphs;
   bit-equal scores, equal band-slot codes and arcs), K6 aligned E-step
   statistics (77k aligned frames, 2000 x 5 x 39).
4. Decodes the committed Yes-No model on the card from waves to words: the
   JAX package's stored hypotheses for all 32 utterances, test WER <= 5%,
   train WER <= 2%, and every decoding kernel launched.
5. Trains the Yes-No monophone model on the card with the port (the recipe
   of ``tools/make_torch_fixture.py``: 14 EM iterations to 200 Gaussians,
   realigned at 1-13), builds its HCLG on the host and decodes with it:
   test WER <= 5%, train WER <= 2%; K2, K4 and K6 launched in training.
   Utterances whose words differ from the JAX-trained model's go to the log.
6. The decoding path at full width: waves -> make_features ->
   Decoder.decode_batch (B = 128 utterances of T = 1000 frames, the
   2000 x 5 x 39 GMM, the 60k-state graph), with the launch counts of this
   run; every utterance must get a T-arc path.  Prints the median audio
   seconds per second of this run and five more; one further run under
   torch.profiler gives the device busy share and time by kernel, one under
   cProfile the host time by function (both into the log).
7. The training path at full width (``bench.py``'s training shape): one EM
   iteration = K2 emissions -> K4 alignment -> K6 statistics -> host M-step
   over 192 utterances of T = 400 frames, 384-state training graphs and the
   2000 x 5 x 39 GMM, with the launch counts of this run (K4's forward
   once per sub-batch); every utterance must align.  Median audio seconds
   per second of this run and five more, and the device busy share of one
   profiled run.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Width:
    batch: int  # utterances
    frames: int  # frames per utterance
    samp_freq: float
    num_states: int
    num_pdfs: int
    max_mix: int
    k3_frames: int  # frames of the K3 comparison
    train_batch: int  # utterances of the training shape
    train_frames: int  # frames per training utterance
    train_states: int  # states per training graph


FULL = Width(batch=128, frames=1000, samp_freq=16000.0, num_states=60_000,
             num_pdfs=2000, max_mix=5, k3_frames=4, train_batch=192, train_frames=400,
             train_states=384)

REPEATS = 5  # timed full-width runs after the counted one
# (rtol, atol); K6's atol is scaled by each accumulator's largest magnitude
TOL = {"mfcc_frames": (2e-4, 2e-3), "gmm_loglikes": (2e-5, 2e-4),
       "viterbi_step": (1e-6, 0.0), "align_forward": (0.0, 0.0),
       "align_backtrace": (0.0, 0.0), "gmm_stats": (1e-5, 1e-5)}
SOURCES = {"mfcc_frames": ("voicebridge_tpu_torch/csrc/mfcc.cu",
                           "voicebridge_tpu/ops/pallas_mfcc.py:57"),
           "gmm_loglikes": ("voicebridge_tpu_torch/csrc/gmm_loglik.cu",
                            "voicebridge_tpu/ops/pallas_gmm.py:81"),
           "viterbi_step": ("voicebridge_tpu_torch/csrc/viterbi_step.cu",
                            "voicebridge_tpu/ops/decode_core.py:268"),
           "align_forward": ("voicebridge_tpu_torch/csrc/align_band.cu",
                             "voicebridge_tpu/ops/align_band.py:186"),
           "align_backtrace": ("voicebridge_tpu_torch/csrc/align_band.cu",
                               "voicebridge_tpu/ops/align_band.py:233"),
           "gmm_stats": ("voicebridge_tpu_torch/csrc/gmm_stats.cu",
                         "voicebridge_tpu/ops/gmm_kernels.py:127")}
DECODE_KERNELS = ("mfcc_frames", "gmm_loglikes", "viterbi_step")
TRAIN_KERNELS = ("gmm_loglikes", "align_forward", "align_backtrace", "gmm_stats")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def synth_waves(width: Width, seed: int = 0):
    """Speech-like test audio: three drifting tones in the speech band and
    noise per utterance, long enough for exactly ``width.frames`` 25 ms /
    10 ms frames.  The tones stay below 1.5 kHz: with strong tones near
    Nyquist, preemphasis leaves the lowest mel bins so far below the frame's
    energy that fp32 rounding alone (against a float64 reference) exceeds
    the MFCC tolerance."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(width.samp_freq * 0.025) + (width.frames - 1) * int(width.samp_freq * 0.010)
    t = np.arange(n) / width.samp_freq
    waves = {}
    for i in range(width.batch):
        f = rng.uniform(100.0, 1500.0, size=3)
        a = rng.uniform(500.0, 4000.0, size=3)
        ph = rng.uniform(0.0, 6.28, size=3)
        sig = sum(a[k] * np.sin(2 * np.pi * f[k] * t * (1 + 0.05 * np.sin(t)) + ph[k])
                  for k in range(3))
        waves[f"utt_{i:04d}"] = (sig + 80.0 * rng.standard_normal(n)).astype(np.float32)
    return waves


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernels(torch, device, width: Width, log) -> dict:
    """Phase 3: every kernel against its plain version at full width."""
    import numpy as np

    from voicebridge_tpu_torch import FrameOptions, MelOptions, MfccOptions, convert
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import features, gmm_kernel, gmm_kernels, mfcc_kernel
    from voicebridge_tpu_torch.testing import random_am, synth_decode_graph

    timed = device.type == "cuda"
    results = {}

    def record(name, pairs, kernel_fn, plain_fn, equal=True):
        """Hold each (kernel, plain) output pair within TOL[name] and time
        both versions."""
        rtol, atol = TOL[name]
        err, ok = 0.0, equal
        for got, ref in pairs:
            got, ref = got.double(), ref.double()
            a = atol * max(1.0, float(ref.abs().max())) if name == "gmm_stats" else atol
            err = max(err, float((got - ref).abs().max()))
            ok = ok and bool(torch.allclose(got, ref, rtol=rtol, atol=a))
        results[name] = {"max_abs_err": err,
                         "ms": cuda_ms(torch, kernel_fn) if timed else None,
                         "plain_ms": cuda_ms(torch, plain_fn) if timed else None}
        log(f"{name}: max_abs_err {err:.3g} (rtol {rtol}, atol {atol}) "
            f"kernel {results[name]['ms']} ms, plain {results[name]['plain_ms']} ms")
        check(ok, f"{name} disagrees with its plain version (max abs err {err})")

    # K1
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=0.0),
                       mel_opts=MelOptions(num_bins=23))
    waves = synth_waves(width)
    wave_t = torch.from_numpy(np.stack(list(waves.values()))).to(device)
    frames = features.extract_frames(wave_t, width.frames, opts.frame_opts)
    frames = frames.reshape(-1, frames.shape[-1]).contiguous()
    tables = features.MfccTables.build(opts, False, device)
    got = mfcc_kernel.mfcc_frames(frames, tables)
    ref = features.mfcc_from_frames(frames, tables)
    record("mfcc_frames", [(got, ref)], lambda: mfcc_kernel.mfcc_frames(frames, tables),
           lambda: features.mfcc_from_frames(frames, tables))
    del got, ref

    # K2
    dim = 39
    am = random_am(width.num_pdfs, width.max_mix, dim)
    w = convert.kernel_params_from_am(am, device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((width.batch * width.frames, dim),
                                             dtype=np.float32)).to(device)
    ll = gmm_kernel.loglikes(x, w)
    ref = gmm_kernels.loglikes(convert.twin_params_from_kernel(w), x)
    record("gmm_loglikes", [(ll, ref)], lambda: gmm_kernel.loglikes(x, w),
           lambda: gmm_kernels.loglikes(convert.twin_params_from_kernel(w), x))
    del ref

    # K3: a few frame steps from the start state, fed the K2 scores
    graph = synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs)
    plan = DC.build_emit_plan(graph, d=8)
    dev = DC.plan_to_device(plan, device)
    b = width.batch
    ll_t = ll.view(b, width.frames, -1).permute(1, 2, 0)[: width.k3_frames].contiguous()
    del ll
    nf = torch.full((b,), width.frames, dtype=torch.int32, device=device)
    s1 = plan.num_states + 1
    alpha0 = np.concatenate([graph.alpha0[plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    alpha = torch.from_numpy(alpha0).to(device)[:, None].expand(s1, b).contiguous()
    acwt = float(np.float32(1.0 / 13.0))
    bp_dtype = torch.uint8 if plan.packed else torch.int16
    worst, codes_equal = None, True
    for t in range(width.k3_frames):
        bp_k = torch.empty((s1, b), dtype=bp_dtype, device=device)
        bp_p = torch.empty_like(bp_k)
        a_k, _ = DC.viterbi_step(alpha, torch.full_like(alpha, DC.NEG_INF), ll_t[t], dev,
                                 nf, t, acwt, plan.rspec, plan.packed, bp_k)
        a_p, _ = DC.viterbi_step_plain(alpha, torch.full_like(alpha, DC.NEG_INF), ll_t[t],
                                       dev, nf, t, acwt, plan.rspec, plan.packed, bp_p)
        codes_equal = codes_equal and bool(torch.equal(bp_k, bp_p))
        if worst is None or (a_k - a_p).abs().max() > (worst[0] - worst[1]).abs().max():
            worst = (a_k, a_p)
        alpha = a_k
    scratch = torch.full_like(alpha, DC.NEG_INF)
    bp = torch.empty((s1, b), dtype=bp_dtype, device=device)
    record("viterbi_step", [worst],
           lambda: DC.viterbi_step(alpha, scratch, ll_t[0], dev, nf, 0, acwt,
                                   plan.rspec, plan.packed, bp),
           lambda: DC.viterbi_step_plain(alpha, scratch, ll_t[0], dev, nf, 0, acwt,
                                         plan.rspec, plan.packed, bp),
           equal=codes_equal)
    check(codes_equal, "viterbi_step backpointer codes differ from the plain version")
    del ll_t, alpha, scratch, bp, dev
    compare_training_kernels(torch, device, width, w, record)
    return results


def train_shape(width: Width, device):
    """The full-width training shape: synthetic banded training graphs, the
    alignment set over them, features and frame counts (numpy seed 3)."""
    import numpy as np
    import torch

    from voicebridge_tpu_torch.steps.align import AlignmentSet
    from voicebridge_tpu_torch.testing import synth_train_graph

    rng = np.random.default_rng(3)
    graphs = [synth_train_graph(width.train_states, width.num_pdfs, rng)
              for _ in range(width.train_batch)]
    feats = torch.from_numpy(rng.standard_normal(
        (width.train_batch, width.train_frames, 39), dtype=np.float32)).to(device)
    nf = np.full(width.train_batch, width.train_frames, np.int32)
    return graphs, AlignmentSet(graphs, device=device), feats, nf


def compare_training_kernels(torch, device, width: Width, w, record) -> None:
    """Phase 3, training half: K4 (forward, backtrace) and K6 against their
    plain versions at the full-width training shape."""
    import numpy as np

    from voicebridge_tpu_torch import convert
    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel

    graphs, aset, feats, nf_np = train_shape(width, device)
    plan = aset.band_dev
    nf = torch.from_numpy(nf_np).to(device)
    ll = gmm_kernel.loglikes_batch(feats, w)
    acwt = 0.1
    fwd = (plan.W, plan.pdf, plan.alpha0, ll, nf, acwt, plan.offsets)
    ae_k, bps_k = AB.viterbi_forward_banded(*fwd)
    ae_p, bps_p = AB.viterbi_forward_banded_plain(*fwd)
    same = bool(torch.equal(ae_k, ae_p) and torch.equal(bps_k, bps_p))
    record("align_forward", [(ae_k, ae_p)], lambda: AB.viterbi_forward_banded(*fwd),
           lambda: AB.viterbi_forward_banded_plain(*fwd), equal=same)
    del bps_p
    bt = (ae_k, plan.final, bps_k, nf, plan.offsets, plan.arc_of)
    got, ref = AB.backtrace_banded(*bt), AB.backtrace_banded_plain(*bt)
    same = all(bool(torch.equal(g, r.to(g.dtype))) for g, r in zip(got, ref))
    record("align_backtrace", [(got[3], ref[3])], lambda: AB.backtrace_banded(*bt),
           lambda: AB.backtrace_banded_plain(*bt), equal=same)
    check(bool(got[2].all()), "align_backtrace: an utterance has no path")
    arcs = got[0].cpu().numpy()
    del ll, bps_k, bt
    pdf = np.stack([graphs[i].arc_pdf[arcs[:, i]] for i in range(len(graphs))])
    x = feats.reshape(-1, feats.shape[2])
    args = (x, x, torch.from_numpy(pdf.reshape(-1)).to(device),
            torch.ones(x.shape[0], dtype=torch.float32, device=device))
    twin = convert.twin_params_from_kernel(w)
    got = gmm_stats_kernel.acc_stats(w, *args, width.num_pdfs)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(twin, *args[:3], width.num_pdfs, args[3])
    record("gmm_stats", list(zip(got, ref)),
           lambda: gmm_stats_kernel.acc_stats(w, *args, width.num_pdfs),
           lambda: gmm_kernels.acc_gmm_stats_aligned_twofeats(twin, *args[:3],
                                                              width.num_pdfs, args[3]))


def decode_yesno(torch, device, log) -> None:
    """Phase 4: the JAX-trained Yes-No model decoded on the device."""
    from synth import make_corpus
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import compute_wer_set, load_yesno_mono

    m = load_yesno_mono()
    train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    dec = Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(beam=1e9), device=device)
    for name, corpus, bound in (("test", test, 5.0), ("train", train, 2.0)):
        feats = make_features({u: w for u, (w, _) in corpus.items()},
                              {u: u for u in corpus}, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        hyps = {r.utt: [m.words.sym(w) for w in r.words]
                for r in dec.decode_batch(utts, batch, nf)}
        stats = compute_wer_set({u: list(corpus[u][1]) for u in utts}, hyps)
        log(f"yes-no {name}: {stats}")
        bad = [u for u in utts if hyps[u] != m.hyps[u]]
        check(not bad, f"yes-no {name}: words differ from the reference for {bad}")
        check(stats.wer <= bound, f"yes-no {name}: WER {stats.wer} > {bound}")


def decode_full_width(torch, device, width: Width, log) -> dict:
    """Phase 6: the decoding path at full width.  Returns timing facts."""
    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import random_am, synth_decode_graph

    waves = synth_waves(width, seed=3)
    utt2spk = {u: f"spk{i % 8}" for i, u in enumerate(sorted(waves))}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                       mel_opts=MelOptions(num_bins=23))
    t0 = time.perf_counter()
    dec = Decoder.from_dense_graph(
        synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs),
        random_am(width.num_pdfs, width.max_mix, 39),
        DecodeOptions(acoustic_scale=1.0 / 13.0), device=device, row_width=8)
    setup_s = time.perf_counter() - t0

    def run():
        t_start = time.perf_counter()
        feats = make_features(waves, utt2spk, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_feats = time.perf_counter()
        res = dec.decode_batch(utts, batch, nf, keep_tids=True)
        t_end = time.perf_counter()
        return res, batch.shape, t_feats - t_start, t_end - t_feats

    from voicebridge_tpu_torch import _build

    for k in _build.launches:
        _build.launches[k] = 0
    res, shape, feat_s, dec_s = run()
    launches = dict(_build.launches)
    check(tuple(shape) == (width.batch, width.frames, 39), f"feature batch shape {shape}")
    check(all(len(r.tids) == width.frames for r in res),
          "an utterance has no path of T arcs")
    check(all(np.isfinite(r.score) for r in res), "a path score is not finite")
    audio_s = width.batch * width.frames * 0.01
    walls = [feat_s + dec_s]
    for _ in range(REPEATS):
        _, _, f_s, d_s = run()
        walls.append(f_s + d_s)
    facts = {"setup_s": setup_s, "first_run_features_s": feat_s,
             "first_run_decode_s": dec_s, "audio_s": audio_s,
             "runs_s": walls, "median_audio_s_per_s": audio_s / float(np.median(walls)),
             "launches": launches}
    if device.type == "cuda":
        facts["profile"] = profile_run(torch, run, log, "full-width decode")
    log(f"full-width decode: {json.dumps(facts)}")
    return facts


def profile_run(torch, run, log, what: str) -> dict:
    """Two more runs of ``run``: one under torch.profiler (device time by
    kernel and the device busy share of the run's wall time), one under
    cProfile (host time by function, into the log)."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    host = cProfile.Profile()
    host.enable()
    run()
    host.disable()
    text = io.StringIO()
    pstats.Stats(host, stream=text).sort_stats("cumulative").print_stats(30)
    log(f"host profile of one {what} run (cProfile):\n" + text.getvalue())
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                              for e in top]}


def train_yesno(torch, device, log) -> dict:
    """Phase 5: the Yes-No monophone model trained on the device by the
    port, then decoded with an HCLG built from it.  Returns the launch
    counts of the training."""
    from synth import LEXICON, make_corpus
    from voicebridge_tpu.config import LangOptions, MonoTrainOptions
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.hclg import mkgraph
    from voicebridge_tpu.lm.arpa import arpa_to_fst
    from voicebridge_tpu.lm.ngram import estimate_ngram
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions, _build
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.steps.train_mono import train_mono
    from voicebridge_tpu_torch.testing import compute_wer_set, load_yesno_mono

    m = load_yesno_mono()
    train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    feats = {name: make_features({u: w for u, (w, _) in corpus.items()},
                                 {u: u for u in corpus}, opts, device=device)
             for name, corpus in (("train", train), ("test", test))}
    transcripts = {u: [lang.words.id(w) for w in words] for u, (_, words) in train.items()}
    for k in _build.launches:
        _build.launches[k] = 0
    t0 = time.perf_counter()
    model = train_mono(feats["train"], transcripts, lang,
                       MonoTrainOptions(num_iters=14, totgauss=200, max_iter_inc=10,
                                        realign_iters=tuple(range(1, 14))), device=device)
    launches = dict(_build.launches)
    log(f"yes-no training on {device}: {time.perf_counter() - t0:.2f} s, "
        f"{model.am.num_gauss} Gaussians, launches {launches}")
    hclg = mkgraph(lang, model.tree, model.trans_model,
                   arpa_to_fst(estimate_ngram([words for (_w, words) in train.values()],
                                              order=2), lang.words.id, lang.word_disambig_id))
    dec = Decoder(hclg, model.trans_model, model.am, DecodeOptions(beam=1e9), device=device)
    for name, corpus, bound in (("test", test, 5.0), ("train", train, 2.0)):
        utts = sorted(corpus)
        batch, nf = pad_features(feats[name], utts)
        hyps = {r.utt: [lang.words.sym(w) for w in r.words]
                for r in dec.decode_batch(utts, batch, nf)}
        stats = compute_wer_set({u: list(corpus[u][1]) for u in utts}, hyps)
        differ = {u: (hyps[u], m.hyps[u]) for u in utts if hyps[u] != m.hyps[u]}
        log(f"yes-no {name}, trained by the port: {stats}; words differ from the "
            f"JAX-trained model's for {len(differ)} utterances: {differ}")
        check(stats.wer <= bound, f"yes-no {name} (port-trained): WER {stats.wer} > {bound}")
    return launches


def train_full_width(torch, device, width: Width, log) -> dict:
    """Phase 7: EM iterations at the full-width training shape.  Returns
    timing facts."""
    import copy
    import math

    import numpy as np

    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import gmm_kernels as K
    from voicebridge_tpu_torch.testing import random_am

    t0 = time.perf_counter()
    graphs, aset, feats, nf = train_shape(width, device)
    am0 = random_am(width.num_pdfs, width.max_mix, 39, seed=4)
    _ = aset.band_dev  # the band plan, built and moved to the device once
    setup_s = time.perf_counter() - t0
    b, t, dim = feats.shape
    x = feats.reshape(b * t, dim)

    def em_iter():
        """K2 -> K4 -> K6 -> host M-step (on a copy of the initial model, so
        every run does the same work)."""
        t_start = time.perf_counter()
        am = copy.deepcopy(am0)
        params = K.pack_gmm(am, device)
        alis = aset.align_feats(params, feats, nf, acoustic_scale=0.1)
        check(all(len(r["arcs"]) == n for r, n in zip(alis, nf)),
              "full-width training: an utterance did not align")
        pdf = np.stack([g.arc_pdf[r["arcs"]] for g, r in zip(graphs, alis)])
        occ, macc, vacc, ll = K.acc_gmm_stats_chunked(params, x, pdf.reshape(-1),
                                                      width.num_pdfs)
        am.mle_update(occ, macc, vacc)
        check(np.isfinite(ll) and np.isfinite(am.means_invvars).all(),
              "full-width training: statistics are not finite")
        return time.perf_counter() - t_start

    sub_batches = math.ceil(b / aset._batch_chunk(t, width.num_pdfs, dim,
                                                  width.train_states + 1))
    for k in _build.launches:
        _build.launches[k] = 0
    walls = [em_iter()]
    launches = dict(_build.launches)
    if device.type == "cuda":
        check(launches["align_forward"] == launches["align_backtrace"] == sub_batches,
              f"K4 launched {launches['align_forward']} times for {sub_batches} sub-batches")
    walls += [em_iter() for _ in range(REPEATS)]
    audio_s = b * t * 0.01
    facts = {"setup_s": setup_s, "audio_s": audio_s, "runs_s": walls, "sub_batches": sub_batches,
             "median_audio_s_per_s": audio_s / float(np.median(walls)), "launches": launches}
    if device.type == "cuda":
        facts["profile"] = profile_run(torch, em_iter, log, "full-width EM")
    log(f"full-width training: {json.dumps(facts)}")
    return facts


def run(device, width: Width, log=print) -> dict:
    """Phases 2-7 on ``device``; returns the kernels report.  On a CPU
    device the wrappers take their plain versions, so this rehearses the
    control flow without kernels."""
    import torch

    from voicebridge_tpu_torch import _build

    def launched(counts, names, what):
        if device.type == "cuda":
            check(all(counts[n] > 0 for n in names), f"{what} skipped a kernel: {counts}")

    if device.type == "cuda":
        t0 = time.perf_counter()
        lib = _build.build()
        log(f"built {lib.name} from {', '.join('csrc/' + s for s in _build.SOURCES)} "
            f"in {time.perf_counter() - t0:.1f} s")
        log(lib.with_suffix(".log").read_text())
        _build.library()
    kernels = compare_kernels(torch, device, width, log)
    for k in _build.launches:
        _build.launches[k] = 0
    decode_yesno(torch, device, log)
    launched(_build.launches, DECODE_KERNELS, "yes-no decode")
    launched(train_yesno(torch, device, log), TRAIN_KERNELS, "yes-no training")
    decode = decode_full_width(torch, device, width, log)
    launched(decode["launches"], DECODE_KERNELS, "the full-width decode")
    train = train_full_width(torch, device, width, log)
    launched(train["launches"], TRAIN_KERNELS, "the full-width EM iteration")
    return {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": decode["launches"][name] + train["launches"][name],
         **kernels[name]} for name in SOURCES], "full_width": decode, "train": train}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    try:
        import voicebridge_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port does not import here: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        print("chip_smoke: TF32 could not be turned off", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / "chip_smoke.log", "w") as logf:
        def log(msg):
            print(msg, file=logf, flush=True)
            print(msg.splitlines()[0] if msg else msg, file=sys.stderr, flush=True)

        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        try:
            report = run(torch.device("cuda", 0), FULL, log)
        except SmokeFailure as e:
            log(f"FAIL: {e}")
            return 1
    for key, what in (("full_width", "decode"), ("train", "EM training")):
        facts = report.pop(key)
        busy = facts["profile"]["device_busy_share"]
        print(f"full-width {what} on {card}: {facts['median_audio_s_per_s']:.1f} audio-s/s "
              f"(median of {len(facts['runs_s'])} runs of {facts['audio_s']:.0f} audio s); "
              f"device busy {100 * busy:.1f} % of one profiled run")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

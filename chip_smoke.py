"""Smoke run of the PyTorch port (voicebridge_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits nonzero):

1. Requires CUDA; turns TF32 off for matmul and cuDNN; prints the card's
   name and power limit (nvidia-smi).
2. Builds the nine CUDA sources from ``voicebridge_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the compiler's
   register/shared-memory report.
3. Holds each kernel against its plain PyTorch version on the card at the
   full-width shapes, and times both with CUDA events:
   K1 MFCC frames (128 x 10 s of audio, 128k frames) at 256, 400, 512, 1024
   and 2048 points (8, 16, 16, 22.05 and 48 kHz; 400: 16 kHz without
   rounding to a power of two; held to the plain version run in float64,
   its gap to the fp32 plain version beside), K2 GMM log-likelihoods (128k frames x 2000
   pdfs x 5 Gaussians x 39 dims, random features; held, like K1, to the
   plain version in float64; its bound on the tensor cores' TF32 rate, which
   its 3xTF32 product uses, beside the fp32 bound and the time of
   ``torch.matmul`` of the product alone), K3 Viterbi frame steps
   over the forward plan (60k-state / 480k-arc graph, B = 128; bit-equal
   scores and backpointer codes) and over the lattice's backward plan
   (bit-equal beta and beta_eff slab), K5 lattice recompute-and-test steps
   on the same graph and lanes (bit-equal alpha, identical survivor bytes,
   and alpha equal to K3's), each one frame a launch and as one window of
   16 frames (its time per frame; the line also carries the one-frame
   time), K4 banded alignment forward and
   backtrace (192 utterances x 400 frames, 384-state training graphs;
   bit-equal scores, equal band-slot codes and arcs; the forward's bound
   counts the 32-byte loglik sectors its states' pdfs touch, the 4-byte
   count beside it; the backtrace also with every 8th utterance's path cut
   at a frame in its middle (a forced failure, equal arcs and ok flags),
   its time for one utterance alone, and its bound by the staged rows'
   bytes beside the chain's), K6 aligned E-step statistics (77k aligned frames,
   2000 x 5 x 39; its work list built on the card bit-equal to the plain
   ``torch.sort`` + ``block_table`` list, two runs bit-equal, at most 3
   device launches a call), with the device time alone (torch.profiler)
   of K4 and K6 beside their time through the wrapper, K7 N-best steps (the
   60k-state graph, 32 lanes x 4 hypotheses per state: as phase 11 runs
   it, all 1000 frames in one launch at exact search, held to the plain
   version frame by frame; and one frame a launch and as one window of 16
   frames, at the start and after a 60-frame window of the kernel alone,
   at exact search and at beam 13, with lanes that end inside the windows;
   bit-equal scores and alpha_end, equal arcs and slots), the generic
   aligner's forward and backtrace through the set's plan, as
   ``align_feats`` runs them (192 x 400 frames over 384-state graphs with
   back arcs, which the banded form refuses; bit-equal scores, equal
   backpointers, byte codes and arcs; one device activity a call, with the
   device time alone; the forward's bound by the 32-byte loglik sectors its
   graphs' distinct pdfs touch, the 4-byte bound beside it; the
   backtrace's by the chain's bytes, the staged codes' bytes beside it),
   and the best-path backtrace ``backtrace_best``
   over the K3 backpointer table of a whole full-width decode block (1000
   frames x 60k states x 128 lanes, keep mode; equal codes, arcs and
   carried state, and its time for one lane alone, the latency floor of
   its chain of dependent loads, beside the time of all 128).  Beside each
   time stands the kernel's
   bound: the larger of its bytes (inputs once, outputs once) over 3.35 TB/s
   and its operations over 67 TFLOP/s (float32; 495 TFLOP/s TF32 for K2),
   from this run's shapes (K1: the sparse mel's nonzeros).  A window's
   bound per frame counts the bytes its launch moves once (the scores in
   and out, the plan) over its frames; the one-frame launch's bound
   stands beside its time.
4. Decodes the committed Yes-No model on the card from waves to words: the
   JAX package's stored hypotheses for all 32 utterances, test WER <= 5%,
   train WER <= 2%, and every decoding kernel launched (K1, K2, K3 and
   ``backtrace_best``); K2 against its plain version on the model and its
   features.
5. Decodes the same model into lattices on the card and sweeps them over
   ``DecodeOptions``' 33-point (LMWT, WIP) grid (``decode_sweep_lattice``):
   every lattice's best path at the decode acoustic scale gives the stored
   hypothesis for all 32 utterances, every frame of every lattice holds an
   arc, test WER at the sweep's best point <= 5%, K1, K2, K3 and K5
   launched.
6. Trains the Yes-No monophone model on the card with the port (the recipe
   of ``tools/make_torch_fixture.py``: 14 EM iterations to 200 Gaussians,
   realigned at 1-13), builds its HCLG on the host and decodes with it:
   test WER <= 5%, train WER <= 2%; K2, K4 and K6 launched in training.
   Utterances whose words differ from the JAX-trained model's go to the log.
7. The decoding path at full width: waves -> make_features ->
   Decoder.decode_batch (B = 128 utterances of T = 1000 frames, the
   2000 x 5 x 39 GMM, the 60k-state graph), with the launch counts of this
   run (K3: one window for all T frames, ``backtrace_best`` one launch per
   K3 block); every utterance must get a T-arc path.  Prints the median audio
   seconds per second of this run and five more; one further run under
   torch.profiler gives the device busy share and time by kernel, one under
   cProfile the host time by function (both into the log).
8. The training path at full width (``bench.py``'s training shape): one EM
   iteration = K2 emissions -> K4 alignment -> K6 statistics -> host M-step
   over 192 utterances of T = 400 frames, 384-state training graphs and the
   2000 x 5 x 39 GMM, with the launch counts of this run (K4's forward
   once per sub-batch; K6 at most 3 device launches a call on the
   iteration's statistics); every utterance must align.  Median audio seconds
   per second of this run and five more, and the device busy share of one
   profiled run.
9. The lattice path at full width: waves -> make_features ->
   Decoder.decode_lattice at the decode shape of phase 7 (acoustic scale
   1/13, the default lattice beam, a GMM of phase 7's size drawn on the
   features' scale; K2 against its plain version on these real features),
   with the launch counts of this run (one launch per window of K3 forward,
   K3 backward and K5).  Every lattice's
   best path must score within 1e-2 or relative 1e-5 of the exact best
   path (``decode_batch``'s search), its arcs rescored in float64, and
   every frame must hold an arc.  Prints survivors per frame and arcs per
   lattice, the median audio seconds per second of this run and five more,
   the device busy share of one profiled run, and the time of one
   decode_sweep_lattice of 16 of the utterances over the 33-point grid,
   timed on its own (its host grid pass dominates).

10. N-best decoding of the Yes-No model on the card (``decode_nbest``,
   nbest 3 and 8): the first hypothesis gives the stored words for all 32
   utterances, scores fall, no two hypotheses share an arc sequence; K1, K2,
   K7 and ``backtrace_nbest`` launched.
11. N-best at full width: waves -> make_features -> Decoder.decode_nbest
   (32 utterances of T = 1000 frames, nbest 4, the 60k-state graph and the
   GMM of phase 9, exact search) in sub-batches sized from the card's free
   memory, with the launch counts of this run.  Every utterance's first
   hypothesis must score within 1e-2 or relative 1e-5 of ``decode_batch``'s
   best path, and scores must fall; K7 and ``backtrace_nbest`` launch once
   per sub-batch, as many as ``decode_nbest``'s sizing rule gives on the
   same free memory.  ``backtrace_nbest`` is then held to its plain version on
   the tables of the first sub-batch (equal arcs, start states and ok
   flags), with its time and its time for one walk.
12. Generic alignment at full width: the training shape of phase 8 over
   graphs with back arcs, which ``build_band_plan`` refuses (the reason goes
   to the log), aligned by ``AlignmentSet.align_feats`` through the generic
   aligner's kernels (its plan built once for the set), with the launch
   counts of this run: one forward and one backtrace a sub-batch; every
   utterance must align.  On the banded set of phase 8 the banded and the generic
   aligner must give equal scores, and equal transition ids unless two best
   paths tie in float32 (both then score the same, rescored in float64).
13. Features at 22.05 kHz and 48 kHz: waves -> make_features on the card
   (K1 at 1024 and 2048 points), 16 utterances each, equal to the plain
   version on the CPU within the MFCC tolerance.
14. The triphone stages on the card.  The committed JAX-trained tri2b model
   (``testing.load_synth_tri2b``) decodes its test utterances from waves
   (``make_features(deltas=None)`` -> ``lda_decode_feats`` ->
   ``decode_batch``, exact search) to the JAX package's stored words for
   every utterance.  The port trains mono -> tri1 (``tests/test_tri.py``'s
   corpus and options; test WER <= 5 %) and mono -> tri2b
   (``tests/test_sat_lda.py``'s; test WER <= 10 %, a 40-row final_mat) on
   the card and decodes with them; which aligner each stage's triphone
   graphs took, and why, goes to the log, and K2, K6 and that aligner's
   kernels must have launched.  SAT: the committed JAX-trained LDA+MLLT+SAT
   model (``testing.load_synth_sat``) through ``decode_fmllr`` on the card
   gives the JAX package's stored words for every test utterance (K1, K2,
   K3 and K5 launched); the port trains delta+SAT (from mono) and
   LDA+MLLT+SAT (from tri2b) on the card with ``tests/test_sat_lda.py``'s
   options and decodes each with ``decode_fmllr``: test WER <= 10 % and
   transforms off the identity by more than 0.01.
15. tri2b at full width (splice +-3 of 13-dim features, LDA to 40, 2000 x 5
   Gaussians).  Training half, at phase 8's shape: a K4 alignment with
   phase 8's model on the features' deltas, then the step's own functions
   (``steps/train_lda_mllt.py``): the LDA estimate, one MLLT update and one
   EM iteration (realignment by K2 and K4, E-step by K6, host M-step),
   timed as phase 8.  Splice, ``acc_lda_stats``, ``apply_affine_transform``
   and ``acc_mllt_stats`` are held to float64 plain versions on the card
   (the CPU tests' tolerances; the LDA second moment's atol scaled by its
   largest entry) with their wall and device times and bounds; K6 at D = 40
   is held to its plain version on the EM iteration's model of uneven
   mixture counts.  Decode half, at phase 7's shape: waves ->
   ``make_features(deltas=None)`` -> ``lda_decode_feats`` -> ``decode_batch``
   over the 60k-state graph with a 2000 x 5 x 40 GMM drawn on the features'
   scale; every utterance must get a T-arc path with a finite score, with
   one K3 window and one ``backtrace_best`` per block; K2 at D = 40 is held
   to its float64 plain version on these features and timed against its
   TF32 bound.
16. SAT at full width (40-dim features, 2000 x 5 Gaussians, 8 speakers).
   Training half, at phase 8's shape with each speaker's features warped
   by a known affine transform near the identity: the step's own functions
   (``steps/train_sat.py``): the initial fMLLR estimate (statistics, row
   solves, projection), one EM iteration in ``fmllr_iters`` (re-estimate,
   K2 + K4 realignment, K6 E-step, host M-step with mixup), then ``alimdl``
   through K6's two-feature path.  Decode half, at phase 7's shape: waves
   -> ``make_features(deltas=None)`` -> ``lda_decode_feats`` (phase 15's
   matrix) -> ``decode_fmllr`` over the 60k-state graph with an AM and an
   ``alimdl`` of 2000 x 5 x 40 drawn on the features' scale, each stage's
   wall time, the launch counts and the device busy share of a second,
   profiled run (two decodes in all).  ``acc_fmllr_stats`` (at both shapes; two runs bit-equal) and
   ``apply_fmllr_batch`` are held to float64 plain versions on the card,
   K6's two-feature path (x_post != x_acc) to its plain version; every
   speaker's objective improvement must be >= 0, every transform finite,
   every utterance must get a T-frame best path with a finite score, and
   stage 4's gathered costs must equal a float64 recompute of the same
   arcs; each with its card time and bound.
17. ``Project`` through the examples: ``examples/yesno_synthetic_torch.main``
   (WER <= 10 %) and ``examples/full_pipeline_synthetic_torch.main`` (mono,
   tri1, tri2b and DELTA+SAT with ``decode_fmllr``: each WER <= 10 % and no
   more than 2 points above the JAX package's on the same sequence,
   ``JAX_FULL_PIPELINE_WER``) on the card, waves on disk to WER; then the
   Yes-No project reopened (each stage loads what the example wrote) and
   decoded with ``out_name``: the same WER, every artifact written, every
   CTM row of positive duration, no overlap within an utterance, the CTM's
   words those of ``transcription.txt``.
18. ``Project`` at LibriSpeech-shaped width: ``examples/librispeech_shaped_torch.py``
   with ``--speakers 24 --utts 8 --test-per 2`` (240 utterances, about 700 s
   of 16 kHz audio) and its defaults otherwise, the whole ladder (mono,
   tri1, tri2b, tri3b with LDA+MLLT+SAT, tri3c with DELTA+SAT; each decode
   over the full LMWT 7-17 x WIP {0, 0.5, 1} grid).  Each stage's wall time,
   audio-s/s and launch counts, the HCLGs' states and arcs, the aligner
   each stage took and the device busy share of a profiled decode are
   printed; each WER must be no more than 2 points above the JAX package's
   on the same arguments (``JAX_LIBRISPEECH_WER``), and the decode
   artifacts are checked as in phase 17.  Then the project is reopened:
   over the mono and tri1 HCLGs that ``mkgraph`` built (hub states of
   thousands of plan rows), the lattice forward-backward (K3 forward and
   backward, K5) and the best path (K3, ``backtrace_best``) of the 4
   longest test utterances must be bit-equal on the card and in the plain
   versions on the CPU, from the same loglikes; so must one generic-aligner
   sub-batch over the tri1 training graphs of the 4 utterances with the
   most states; both plans' rows and D are printed, and every test
   utterance must get a finite best path over the tri1 graph.
19. The remaining frontends and speaker adaptation, each run counted (its
   launch counts read just after it).  Silence probabilities: phase 18's
   project reopened, its training split aligned with the tri1 model, then
   ``get_prons``, ``estimate_silence_probs``, ``prepare_lang(silprobs=...)``,
   ``mkgraph`` and one lattice decode of the test split: WER no more than 2
   points above phase 18's tri1 WER.  Features: phase 7's waves through
   ``PlpExtractor`` (K1 in ``mel_power`` mode, then the PLP tail),
   ``FbankExtractor`` at 40 bins and ``SpectrogramExtractor``; K1's
   ``mel_power`` rows (its own kernel entry, ``mfcc_mel_power``: the mel
   energies as logs floored at FLT_EPS, and the log energy) and its
   ``fbank`` rows are held to the plain version in float64 with the MFCC
   tolerance and timed against their bytes bound, the PLP tail and the
   spectrogram to float64 versions; ``make_features(pitch=True)`` on the
   first ``PITCH_UTTS`` waves against the CPU.  Adaptation at phase 16's
   shape (the 2000 x 5 x 40 GMM, 8 speakers, 76,800 frames): a regression
   tree of 8 base classes, per speaker ``acc_regtree_fmllr_stats``,
   ``estimate_regtree_fmllr`` and ``regtree_fmllr_loglikes`` (K2 once per
   regression class), ``acc_regtree_mllr_stats`` (K6), a basis trained from
   the speakers' fMLLR statistics, and a 1 x 512 x 40 full-covariance GMM
   (``FullGmm.from_diag``) through ``loglikes_full`` and ``acc_full_stats``
   over all frames; then each held to a float64 version and timed against
   its bound (K2's per-class launches each to K2's plain version in
   float64).

20. The last slice (PR 16), about 150 s.  The TF32 repair: with
   ``torch.set_float32_matmul_precision("high")`` set for the phase, the
   deltas of phase 9's base features, their LDA decode features under phase
   15's matrix and ``acc_fmllr_stats`` at phase 16's shape equal, bit for
   bit, the same calls with TF32 off, and the flag reads ``"tf32"`` after
   each.  Multi-device statistics (``parallel/``): at world size 1 over
   NCCL in this process (a file store, the group destroyed after),
   ``em_estep_sharded_banded`` at phase 8's shape (its K4 alignment as the
   given one), ``em_estep_sharded`` over phase 12's generic graphs, the LDA,
   MLLT, fMLLR (8 speakers) and tree accumulators at phases 15, 16 and 8's
   shapes and ``decode_forward_sharded`` at phase 7's shape (phase 9's
   graph and features), each held to the port's unsharded function
   (alignments, K3's scores and codes bit-equal, float64 statistics within
   rtol 1e-9, MLLT's and fMLLR's, which add fp32 posteriors, within
   ``POSTERIOR_RTOL``, K6's sums within rtol 1e-5) and timed with its all-reduce
   beside it and its bound; then world size 2 over ``gloo``, both ranks on
   ``cuda:0`` started with ``spawn`` and a join limit, the banded E-step and
   the four accumulators held to world size 1 (each rank's ``alpha_end``
   block = world size 1's rows).  The lane-major lattice FB
   (``csrc/lattice_lane.cu``) at phase 9's shape at exact search: packed
   survivor bytes equal the plain version's on the card, ``total_best`` =
   ``decode_batch``'s exact best-path scores within 1e-2 or relative 1e-5;
   16 lanes at beam 13 and max_active 2000 byte for byte; timed against its
   bound at exact search and, on all lanes, at beam 13 and max_active 2000,
   its launches counted (3 per window) and its device kernels under
   torch.profiler (one per window and pass).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
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
    k3_frames: int  # frames of the K3 and K5 comparisons (one window)
    train_batch: int  # utterances of the training shape
    train_frames: int  # frames per training utterance
    train_states: int  # states per training graph
    back_arcs: int  # back arcs per graph of the non-banded training set
    nbest_batch: int  # utterances of the N-best shape
    nbest: int  # hypotheses per state
    nbest_warm: int  # frames run before the second K7 comparison
    sweep_batch: int  # utterances of the timed host sweep


FULL = Width(batch=128, frames=1000, samp_freq=16000.0, num_states=60_000,
             num_pdfs=2000, max_mix=5, k3_frames=16, train_batch=192, train_frames=400,
             train_states=384, back_arcs=2, nbest_batch=32, nbest=4, nbest_warm=60, sweep_batch=16)

REPEATS = 5  # timed full-width runs after the counted one
# phase 18's corpus: speakers, train and test utterances per speaker
LS_SPEAKERS, LS_UTTS, LS_TEST_PER = 24, 8, 2
LS_PARITY_UTTS = 4  # utterances of phase 18's card-against-plain checks
# The JAX package's WERs (%) on phases 17 and 18's sequences, run on the CPU
# by tools/project_reference_wer.py (full_pipeline; librispeech)
JAX_FULL_PIPELINE_WER = {"mono": 0.0, "tri1": 0.0, "tri2b": 3.125, "tri3b": 0.0}
JAX_LIBRISPEECH_WER = {"mono": 4.32, "tri1": 4.9, "tri2b": 4.61, "tri3b": 1.73, "tri3c": 2.88}
EXACT_BEAM = 1e9  # the full-width N-best path's beam: exact search
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores, published
TF32_OPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense, published
# K1's padded window sizes held at full width: (sample rate, round to a power of two)
K1_SIZES = {256: (8000.0, True), 400: (16000.0, False), 512: (16000.0, True),
            1024: (22050.0, True), 2048: (48000.0, True)}
K1_RATES = (22050.0, 48000.0)  # make_features on the card at these rates (phase 13)
# (rtol, atol); K6's atol is scaled by each accumulator's largest magnitude
TOL = {"mfcc_frames": (2e-4, 2e-3), "mfcc_mel_power": (2e-4, 2e-3),
       "gmm_loglikes": (2e-5, 2e-4),
       "viterbi_step": (0.0, 0.0), "viterbi_step_backward": (0.0, 0.0),
       "align_forward": (0.0, 0.0),
       "align_backtrace": (0.0, 0.0), "gmm_stats": (1e-5, 1e-5), "lattice_fb": (0.0, 0.0),
       "viterbi_nbest": (0.0, 0.0), "generic_forward": (0.0, 0.0),
       "generic_backtrace": (0.0, 0.0), "backtrace_best": (0.0, 0.0),
       "backtrace_nbest": (0.0, 0.0), "lattice_lane": (0.0, 0.0)}
SOURCES = {"mfcc_frames": ("voicebridge_tpu_torch/csrc/mfcc.cu",
                           "voicebridge_tpu/ops/pallas_mfcc.py:57"),
           # K1 in mel_power mode, PLP's front half (counted apart)
           "mfcc_mel_power": ("voicebridge_tpu_torch/csrc/mfcc.cu",
                              "voicebridge_tpu/ops/pallas_mfcc.py:57"),
           "gmm_loglikes": ("voicebridge_tpu_torch/csrc/gmm_loglik.cu",
                            "voicebridge_tpu/ops/pallas_gmm.py:81"),
           "viterbi_step": ("voicebridge_tpu_torch/csrc/viterbi_step.cu",
                            "voicebridge_tpu/ops/decode_core.py:268"),
           "viterbi_step_backward": ("voicebridge_tpu_torch/csrc/viterbi_step.cu",
                                     "voicebridge_tpu/ops/lattice.py:386"),
           "align_forward": ("voicebridge_tpu_torch/csrc/align_band.cu",
                             "voicebridge_tpu/ops/align_band.py:186"),
           "align_backtrace": ("voicebridge_tpu_torch/csrc/align_band.cu",
                               "voicebridge_tpu/ops/align_band.py:233"),
           "gmm_stats": ("voicebridge_tpu_torch/csrc/gmm_stats.cu",
                         "voicebridge_tpu/ops/gmm_kernels.py:127"),
           "lattice_fb": ("voicebridge_tpu_torch/csrc/lattice_fb.cu",
                          "voicebridge_tpu/ops/lattice.py:367"),
           "viterbi_nbest": ("voicebridge_tpu_torch/csrc/viterbi_nbest.cu",
                             "voicebridge_tpu/ops/viterbi.py:513"),
           "generic_forward": ("voicebridge_tpu_torch/csrc/viterbi_generic.cu",
                               "voicebridge_tpu/ops/viterbi.py:452"),
           "generic_backtrace": ("voicebridge_tpu_torch/csrc/viterbi_generic.cu",
                                 "voicebridge_tpu/ops/viterbi.py:842"),
           "backtrace_best": ("voicebridge_tpu_torch/csrc/backtrace.cu",
                              "voicebridge_tpu/ops/decode_core.py:351"),
           # no TPU kernel: the JAX package walks the N-best tables on the host
           "backtrace_nbest": ("voicebridge_tpu_torch/csrc/backtrace.cu",
                               "voicebridge_tpu/ops/viterbi.py:561"),
           # the lane-major lattice FB (with _window_fb, lattice.py:44)
           "lattice_lane": ("voicebridge_tpu_torch/csrc/lattice_lane.cu",
                            "voicebridge_tpu/ops/lattice.py:99")}
DECODE_KERNELS = ("mfcc_frames", "gmm_loglikes", "viterbi_step", "backtrace_best")
TRAIN_KERNELS = ("gmm_loglikes", "align_forward", "align_backtrace", "gmm_stats")
LATTICE_KERNELS = ("mfcc_frames", "gmm_loglikes", "viterbi_step", "viterbi_step_backward",
                   "lattice_fb")
NBEST_KERNELS = ("mfcc_frames", "gmm_loglikes", "viterbi_nbest", "backtrace_nbest")
GENERIC_KERNELS = ("gmm_loglikes", "generic_forward", "generic_backtrace")
# what a Project sequence launches, besides its aligner (K1-K6: features,
# training, lattice decode)
PROJECT_KERNELS = ("mfcc_frames", "gmm_loglikes", "gmm_stats", "viterbi_step",
                   "viterbi_step_backward", "lattice_fb")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def reset_launches() -> None:
    from voicebridge_tpu_torch import _build

    for k in _build.launches:
        _build.launches[k] = 0


def launch_counts() -> dict:
    from voicebridge_tpu_torch import _build

    return dict(_build.launches)


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


def cuda_ms_cold(torch, fn, warm: tuple, reps: int = 5) -> float:
    """``cuda_ms`` with the L2 cache flushed before each run (a 256 MB
    write) and then only ``warm`` read back into it (the plan's arrays, as a
    caller finds them), so the tables ``fn`` walks come from device memory."""
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        for x in warm:
            x.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_ops(frames: int, ws: int, n_fft: int, tables) -> float:
    """K1's operations, counted from the work the chain needs: per frame the
    window chain, a real FFT (an N/2-point complex FFT and its split) and
    the power spectrum, the mel's nonzeros, and in ``mfcc`` mode the DCT
    and the lifter."""
    bins, ceps = tables.dct_t.shape
    half = n_fft // 2
    dct = 2 * bins * ceps + ceps if tables.mode == "mfcc" else 0
    return frames * (5 * ws + 5 * half * math.log2(half) + 13 * half
                     + 2 * int(tables.mel_len.sum()) + dct)


def k2_plain64(x, w):
    """K2's plain version in float64: the reference it is held to (on the
    Yes-No model's training features the fp32 plain version is itself 1.2
    times the tolerance away from it: the expanded form cancels terms of up
    to 1e4)."""
    import torch

    from voicebridge_tpu_torch.ops import gmm_kernels

    return gmm_kernels.loglikes(w.to(torch.float64), x.double())


def k2_check(torch, x, w, what: str, log) -> float:
    """K2 against its plain version in float64 on ``x``; returns the max abs
    error (the gap to the fp32 plain version goes to the log)."""
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels

    rtol, atol = TOL["gmm_loglikes"]
    got = gmm_kernel.loglikes(x, w).double()
    ref = k2_plain64(x, w)
    err = float((got - ref).abs().max())
    fp32 = gmm_kernels.loglikes(w, x).double()
    log(f"gmm_loglikes on {what}: max abs err {err:.3g} against the float64 plain version, "
        f"{float((got - fp32).abs().max()):.3g} against the fp32 one (which is "
        f"{float((fp32 - ref).abs().max()):.3g} from the float64 one)")
    # on the CPU the wrapper is the fp32 plain version itself: no kernel to hold
    check(x.device.type == "cpu" or bool(torch.allclose(got, ref, rtol=rtol, atol=atol)),
          f"gmm_loglikes on {what} disagrees with its plain version (max abs err {err})")
    return err


def make_record(torch, results: dict, log, timed: bool):
    """The comparison of phase 3 and 11: returns ``record``, which keeps each
    kernel's entry in ``results``."""

    def record(name, pairs, kernel_fn, plain_fn, work, equal=True, frames=1, frame_fn=None,
               launch_bytes=0, frame_launch_bytes=None, ops_per_s=FP32_OPS_PER_S, what=""):
        """Hold each (kernel, plain) output pair within TOL[name], time both
        versions, and work out the kernel's bound from ``work``: the bytes
        it must move (inputs once, outputs once) and its operations, at
        ``ops_per_s`` for their type.  A ``kernel_fn`` that runs a window of
        ``frames`` frames in one launch is timed per frame; ``frame_fn``,
        the same kernel one frame per launch, is timed beside it;
        ``plain_fn`` and ``work`` are one frame's, and ``launch_bytes`` are
        the bytes a launch moves once whatever its frames (the scores in
        and out, the plan), so the window's bound per frame counts them
        over its frames and the one-frame launch's in full
        (``frame_launch_bytes`` where the one-frame launch moves other such
        bytes than the window).  Returns the entry (and keeps it as the
        kernel's unless ``what`` names a side case)."""
        rtol, atol = TOL[name]
        err, ok = 0.0, equal
        for got, ref in pairs:
            got, ref = got.double(), ref.double()
            a = atol * max(1.0, float(ref.abs().max())) if name == "gmm_stats" else atol
            err = max(err, float((got - ref).abs().max()))
            ok = ok and bool(torch.allclose(got, ref, rtol=rtol, atol=a))
        byte_ms = 1e3 * (work[0] + launch_bytes / frames) / HBM_BYTES_PER_S
        op_ms = 1e3 * work[1] / ops_per_s
        entry = {"max_abs_err": err,
                 "ms": cuda_ms(torch, kernel_fn) / frames if timed else None,
                 "plain_ms": cuda_ms(torch, plain_fn) if timed else None,
                 "bound_ms": max(byte_ms, op_ms),
                 "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                 "library_ms": None}  # no single PyTorch call computes it
        if frame_fn is not None:
            entry["window_frames"] = frames
            entry["frame_launch_ms"] = cuda_ms(torch, frame_fn) if timed else None
            once = launch_bytes if frame_launch_bytes is None else frame_launch_bytes
            entry["frame_launch_bound_ms"] = max(1e3 * (work[0] + once) / HBM_BYTES_PER_S,
                                                 op_ms)
        if not what:
            results[name] = entry
        log(f"{name}{what}: max_abs_err {err:.3g} (rtol {rtol}, atol {atol}) "
            f"kernel {entry['ms']} ms (per frame, {frames} frames a launch), "
            f"one frame a launch {entry.get('frame_launch_ms')} ms "
            f"(bound {entry.get('frame_launch_bound_ms')} ms), plain {entry['plain_ms']} ms; "
            f"{work[0]:.4g} bytes a frame and {launch_bytes:.4g} a launch ({byte_ms:.4g} ms a "
            f"frame), {work[1]:.4g} operations ({op_ms:.4g} ms)")
        check(ok, f"{name}{what} disagrees with its plain version (max abs err {err})")
        return entry

    return record


def k3_plan_bytes(dev) -> int:
    """The bytes of the emit plan that K3 and K5 read (not ``row_arc``,
    which only the backtrace reads)."""
    return nbytes(dev.row_src, dev.row_w, dev.row_pdf, dev.row_start, dev.row_real)


def compare_kernels(torch, device, width: Width, results: dict, record, log) -> dict:
    """Phase 3: every kernel against its plain version at full width."""
    import numpy as np

    from voicebridge_tpu_torch import FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import features, gmm_kernel, gmm_kernels, mfcc_kernel
    from voicebridge_tpu_torch.testing import random_am, synth_decode_graph

    timed = device.type == "cuda"

    # K1 at each size of K1_SIZES (the main path's is the kernel's entry)
    main_fft = FrameOptions(samp_freq=width.samp_freq).padded_window_size
    sizes = {}
    for n_fft, (sr, pow2) in K1_SIZES.items():
        opts = MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0,
                                                   round_to_power_of_two=pow2),
                           mel_opts=MelOptions(num_bins=23))
        check(opts.frame_opts.padded_window_size == n_fft, f"K1 size {n_fft}")
        waves = synth_waves(dataclasses.replace(width, samp_freq=sr))
        wave_t = torch.from_numpy(np.stack(list(waves.values()))).to(device)
        del waves
        frames = features.extract_frames(wave_t, width.frames, opts.frame_opts)
        frames = frames.reshape(-1, frames.shape[-1]).contiguous()
        del wave_t
        tables = features.MfccTables.build(opts, False, device)
        got = mfcc_kernel.mfcc_frames(frames, tables)
        ref = features.mfcc_from_frames(frames, tables)
        # held to the plain version in float64: at 8 kHz the lowest mel bins
        # lie so far below the frame's power (preemphasis) that the fp32
        # plain version's own rounding is about the tolerance
        t64 = dataclasses.replace(tables, **{f: getattr(tables, f).double()
                                             for f in ("window", "mel_t", "dct_t", "lifter")})
        ref64 = features.mfcc_from_frames(frames.double(), t64)
        sizes[n_fft] = record(
            "mfcc_frames", [(got, ref64)], lambda: mfcc_kernel.mfcc_frames(frames, tables),
            lambda: features.mfcc_from_frames(frames, tables),
            (nbytes(frames, got), k1_ops(frames.shape[0], frames.shape[1], n_fft, tables)),
            what="" if n_fft == main_fft else f" at {n_fft} points")
        sizes[n_fft]["max_abs_err_vs_fp32_plain"] = float((got.double() - ref.double())
                                                          .abs().max())
        log(f"mfcc_frames at {n_fft} points: max abs difference from the fp32 plain version "
            f"{sizes[n_fft]['max_abs_err_vs_fp32_plain']:.3g}")
        del got, ref, ref64, frames
    results["mfcc_frames"]["sizes"] = {str(n): dict(e) for n, e in sizes.items()}

    # K2 on random features; both bounds, and torch.matmul of the product
    # alone as a yardstick (the port never calls it)
    dim = 39
    am = random_am(width.num_pdfs, width.max_mix, dim)
    w = gmm_kernels.pack_gmm(am, device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((width.batch * width.frames, dim),
                                             dtype=np.float32)).to(device)
    ll = gmm_kernel.loglikes(x, w)
    ref = gmm_kernels.loglikes(w, x)
    ref64 = k2_plain64(x, w)
    n, p, m = x.shape[0], w.num_pdfs, w.max_mix
    kp = gmm_kernel.k_pad(w.w.shape[2])
    # 3xTF32: three products a step (hi.hi, hi.lo, lo.hi) over K padded to 8
    record("gmm_loglikes", [(ll, ref64)], lambda: gmm_kernel.loglikes(x, w),
           lambda: gmm_kernels.loglikes(w, x),
           (nbytes(x, w.w, ll), 3 * 2 * n * p * m * kp), ops_per_s=TF32_OPS_PER_S)
    results["gmm_loglikes"]["max_abs_err_vs_fp32_plain"] = float((ll.double() - ref.double())
                                                                 .abs().max())
    del ref, ref64
    xx = torch.cat([x, x * x, torch.ones_like(x[:, :1])], dim=1)
    wm = w.w.reshape(p * m, -1).T.contiguous()  # [2D+1, P*M]
    # one multiply-add per (frame, Gaussian, row of [x, x^2])
    fp32_ms = 1e3 * 2 * n * p * m * 2 * dim / FP32_OPS_PER_S
    results["gmm_loglikes"].update(
        fp32_bound_ms=fp32_ms, route_detail="3xTF32, mma.sync m16n8k8",
        matmul_yardstick_ms=cuda_ms(torch, lambda: xx @ wm) if timed else None)
    del xx, wm
    log(f"gmm_loglikes: fp32 bound {fp32_ms:.4g} ms, torch.matmul of the product alone "
        f"{results['gmm_loglikes']['matmul_yardstick_ms']} ms")

    # K3 over the forward plan: k3_frames frames from the start state, fed
    # the K2 scores, once a frame a launch (W = 1) and once as one window,
    # both against the plain version
    graph = synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs)
    plan = DC.build_emit_plan(graph, d=8)
    dev = DC.plan_to_device(plan, device)
    b, k = width.batch, width.k3_frames
    ll_all = ll.view(b, width.frames, -1).permute(1, 2, 0).contiguous()  # [T, P, B]
    ll_t = ll_all[:k]
    ll_k = ll.view(b, width.frames, -1)[:, :k].contiguous()
    del ll
    nf = torch.full((b,), width.frames, dtype=torch.int32, device=device)
    s1 = plan.num_states + 1
    alpha0 = np.concatenate([graph.alpha0[plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    alpha = torch.from_numpy(alpha0).to(device)[:, None].expand(s1, b).contiguous()
    acwt = float(np.float32(1.0 / 13.0))
    scan = (dev, nf, 0, acwt, plan.rspec, plan.packed)
    bp_dtype = torch.uint8 if plan.packed else torch.int16
    bps = {m: torch.empty((k, s1, b), dtype=bp_dtype, device=device) for m in "1wp"}
    ends = {m: torch.full_like(alpha, DC.NEG_INF) for m in "1wp"}
    k3_alphas = [alpha]
    for t in range(k):
        a1, _ = DC.viterbi_step(k3_alphas[-1], ends["1"], ll_t[t], dev, nf, t, acwt,
                                plan.rspec, plan.packed, bps["1"][t])
        k3_alphas.append(a1)
    a_w, _ = DC.viterbi_window(alpha, ends["w"], ll_t, *scan, bps["w"])
    a_p, _ = DC.viterbi_window_plain(alpha, ends["p"], ll_t, *scan, bps["p"])
    same = all(bool(torch.equal(x, y)) for x, y in (
        (a1, a_p), (a_w, a_p), (bps["1"], bps["p"]), (bps["w"], bps["p"]),
        (ends["1"], ends["p"]), (ends["w"], ends["p"])))
    log(f"viterbi_step: {k} frames x {b} lanes over the forward plan ({plan.num_rows} rows x "
        f"D = {plan.d}, {int((plan.row_arc >= 0).sum())} real slots), one frame a launch and "
        f"one window, bit-equal to the plain version: {same}")
    record("viterbi_step", [(a1, a_p), (a_w, a_p)],
           lambda: DC.viterbi_window(alpha, ends["w"], ll_t, *scan, bps["w"]),
           lambda: DC.viterbi_step_plain(alpha, ends["p"], ll_t[0], dev, nf, 0, acwt,
                                         plan.rspec, plan.packed, bps["p"][0]),
           # a frame's logliks and backpointers; alpha in and out and the plan
           # once a launch; an add and a compare per (row slot, lane), an add
           # and a compare per row
           (nbytes(ll_t[0], bps["w"][0]),
            2 * dev.row_src.numel() * b + 2 * plan.num_rows * b), equal=same, frames=k,
           frame_fn=lambda: DC.viterbi_step(alpha, ends["1"], ll_t[0], dev, nf, 0, acwt,
                                            plan.rspec, plan.packed, bps["1"][0]),
           launch_bytes=2 * nbytes(alpha) + nbytes(nf) + k3_plan_bytes(dev))
    check(same, "viterbi_step scores or backpointer codes differ from the plain version")
    compare_backtrace_best(torch, graph, plan, dev, alpha, ll_all, acwt, record, log)
    ll_nbest = ll_all[:, :, :width.nbest_batch].contiguous()  # [T, P, B] of phase 11's lanes
    del alpha, bps, ends, ll_all
    compare_lattice_kernel(torch, device, graph, plan, dev, ll_k, ll_t, k3_alphas, acwt,
                           record, log)
    del k3_alphas, dev
    del ll_k
    compare_nbest_kernel(torch, device, width, graph, ll_nbest, acwt, record, log)
    del ll_t, ll_nbest
    compare_training_kernels(torch, device, width, w, record, log)
    compare_generic_kernels(torch, device, width, w, record, log)
    return results


def compare_backtrace_best(torch, graph, plan, dev, alpha, ll, acwt, record, log) -> None:
    """Phase 3, the best-path backtrace over a whole full-width decode block
    as ``decode_best_path`` runs it in keep mode: K3's backpointer table of
    all T frames (one window), the end states ``select_end_state`` picks,
    then ``backtrace_best`` against its plain version.  Its time for one
    lane, a single chain of dependent loads, goes beside the bound."""
    from voicebridge_tpu_torch.ops import decode_core as DC

    device = alpha.device
    t, _p, b = ll.shape
    s1 = alpha.shape[0]
    nf = torch.full((b,), t, dtype=torch.int32, device=device)
    nf[: b // 4] = torch.arange(t - b // 4, t, dtype=torch.int32, device=device)  # ragged ends
    bps = torch.empty((t, s1, b), dtype=torch.uint8 if plan.packed else torch.int16,
                      device=device)
    ae = torch.full_like(alpha, DC.NEG_INF)
    DC.viterbi_window(alpha, ae, ll, dev, nf, 0, acwt, plan.rspec, plan.packed, bps)
    final = torch.from_numpy(graph.final_score[plan.sperm[:-1]]).to(device)
    end = DC.select_end_state(ae, final)[0].to(torch.int32)
    walk = (bps, end, nf, 0)
    plain = (dev.row_start, dev.row_src, dev.row_arc, plan.d, *walk)
    got = DC.backtrace_scan(dev, *walk)
    ref = DC.backtrace_scan_plain(*plain)
    same = all(bool(torch.equal(x, y)) for x, y in zip(got, ref))
    check(bool((got[1] >= 0).sum(dim=0).eq(nf).all()), "backtrace_best: a lane has no path")
    one = (bps[:, :, :1].contiguous(), end[:1].contiguous(), nf[:1].contiguous(), 0)
    log(f"backtrace_best: {t} frames x {b} lanes over the K3 table of one decode block "
        f"({bps.element_size()} byte codes), equal to the plain version: {same}")
    # per (frame, lane): the code read, row_start, row_src and row_arc
    # looked up, the code and the arc written; the end states in, the start
    # states out; a multiply-add and a compare each
    entry = record("backtrace_best", [(got[1], ref[1])], lambda: DC.backtrace_scan(dev, *walk),
                   lambda: DC.backtrace_scan_plain(*plain),
                   (t * b * (bps.element_size() + 20) + nbytes(end, nf, end),
                    3 * t * b), equal=same)
    check(all(bool(torch.equal(x, y)) for x, y in zip(DC.backtrace_scan(dev, *one),
                                                      (got[0][:, :1], got[1][:, :1], got[2][:1]))),
          "backtrace_best: one lane alone differs from the same lane among all")
    entry["one_lane_ms"] = cuda_ms(torch, lambda: DC.backtrace_scan(dev, *one)) \
        if device.type == "cuda" else None
    log(f"backtrace_best: all {b} lanes {entry['ms']} ms, one lane alone (the chain of {t} "
        f"dependent frames, its latency floor) {entry['one_lane_ms']} ms; bytes bound "
        f"{entry['bound_ms']:.4g} ms")


def compare_lattice_kernel(torch, device, graph, plan, dev, ll_k, ll_t, k3_alphas, acwt,
                           record, log) -> None:
    """Phase 3, lattice phase 2 over the K3 frames, as the lattice FB runs it
    for utterances of that many frames: K3 over the backward plan with the
    beta_eff select and slab store fused (``bwd_window``), then K5, the
    recompute-and-test step, with the threshold from the FB itself.  Each
    runs one frame a launch and as one window, against its plain version on
    the same inputs; K5's recomputed alpha must also equal K3's forward
    alpha."""
    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import lattice as LAT

    b, k, _p = ll_k.shape
    beam = float(np.float32(DecodeOptions().lattice_beam))
    plans = LAT.build_lattice_plans(graph, fwd_plan=plan, device=device)
    _fwd, _fwd_dev, bwd_plan, bwd_dev, row_dst = plans
    _surv, best, _end, use_final = LAT.lattice_forward_backward_rows(
        graph, *plans, ll_k, np.full(b, k, np.int32), acwt, beam, window=k)
    check(bool(use_final.all()), "K5 inputs: a lane reaches no final state")
    thresh = (best - beam).contiguous()
    final_eff = torch.from_numpy(np.concatenate(
        [graph.final_score[bwd_plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)).to(device)
    final_eff = final_eff[:, None].expand(-1, b).contiguous()
    nf = torch.full((b,), k, dtype=torch.int32, device=device)
    row_dst = torch.from_numpy(row_dst).to(device)
    beta0 = torch.full_like(k3_alphas[0], DC.NEG_INF)
    bwd = (bwd_dev, nf, 0, acwt, bwd_plan.rspec, bwd_plan.packed, final_eff)
    slabs = {m: torch.empty((k,) + tuple(beta0.shape), device=device) for m in "1wp"}
    beta1 = beta0
    for t in range(k - 1, -1, -1):
        beta1 = LAT.bwd_window(beta1, ll_t[t:t + 1], bwd_dev, nf, t, acwt, bwd_plan.rspec,
                               bwd_plan.packed, final_eff, slabs["1"][t:t + 1])
    beta_w = LAT.bwd_window(beta0, ll_t, *bwd, slabs["w"])
    beta_p = LAT.bwd_window_plain(beta0, ll_t, *bwd, slabs["p"])
    same = all(bool(torch.equal(x, y)) for x, y in (
        (beta1, beta_p), (beta_w, beta_p), (slabs["1"], slabs["p"]), (slabs["w"], slabs["p"])))
    log(f"viterbi_step_backward: {k} frames x {b} lanes over the backward plan "
        f"({bwd_plan.num_rows} rows x D = {bwd_plan.d}, {int((bwd_plan.row_arc >= 0).sum())} "
        f"real slots), bit-equal to the plain version: {same}")
    # a frame's slab slice out and its logliks; beta out, the plan and the
    # final scores once a launch (every lane ends at the window's last frame,
    # so the window reads final_eff and not beta0, and the one-frame launch
    # at frame 0 reads beta0 and not final_eff); an add and a compare per
    # (row slot, lane), an add and a compare per row
    slab = slabs["w"]
    record("viterbi_step_backward", [(beta1, beta_p), (beta_w, beta_p)],
           lambda: LAT.bwd_window(beta0, ll_t, *bwd, slab),
           lambda: LAT.bwd_window_plain(beta0, ll_t[:1], *bwd, slabs["p"][:1]),
           (nbytes(slab[0], ll_t[0]),
            2 * bwd_dev.row_src.numel() * b + 2 * bwd_plan.num_rows * b), equal=same,
           frames=k, frame_fn=lambda: LAT.bwd_window(beta0, ll_t[:1], *bwd, slab[:1]),
           launch_bytes=nbytes(beta0, nf, final_eff) + k3_plan_bytes(bwd_dev),
           frame_launch_bytes=2 * nbytes(beta0) + nbytes(nf) + k3_plan_bytes(bwd_dev))
    check(same, "viterbi_step_backward differs from the plain version")
    words = {m: torch.empty((k, plan.num_rows, b), dtype=torch.uint8, device=device)
             for m in "1wp"}
    fb = (dev, row_dst, slab, nf, 0, acwt, thresh, plan.rspec)
    a1 = k3_alphas[0]
    same = True
    for t in range(k):
        a1 = LAT.fb_frame(a1, ll_t[t], dev, row_dst, slab[t], nf, t, acwt, thresh, plan.rspec,
                          words["1"][t])
        same = same and bool(torch.equal(a1, k3_alphas[t + 1]))
    a_w = LAT.fb_frames(k3_alphas[0], ll_t, *fb, words["w"])
    a_p = LAT.fb_frames_plain(k3_alphas[0], ll_t, *fb, words["p"])
    same = same and all(bool(torch.equal(x, y)) for x, y in (
        (a1, a_p), (a_w, a_p), (words["1"], words["p"]), (words["w"], words["p"])))
    log(f"lattice_fb: {k} frames x {b} lanes, survivor bytes nonzero "
        f"{int((words['p'][-1] != 0).sum())} of {words['p'][-1].numel()} in the last frame; "
        f"bit-equal to the plain version and its alpha to K3's: {same}")
    # a frame's beta slab slice and logliks in and survivor bytes out;
    # alpha in and out, the plan, row_dst and the threshold once a launch;
    # per row slot the forward add and compare and the survivor test's two
    # adds and compare
    record("lattice_fb", [(a1, a_p), (a_w, a_p)],
           lambda: LAT.fb_frames(k3_alphas[0], ll_t, *fb, words["w"]),
           lambda: LAT.fb_frame_plain(k3_alphas[0], ll_t[0], dev, row_dst, slab[0], nf, 0,
                                      acwt, thresh, plan.rspec),
           (nbytes(slab[0], ll_t[0], words["w"][0]),
            5 * dev.row_src.numel() * b + 2 * plan.num_rows * b), equal=same, frames=k,
           frame_fn=lambda: LAT.fb_frame(k3_alphas[0], ll_t[0], dev, row_dst, slab[0], nf, 0,
                                         acwt, thresh, plan.rspec, words["1"][0]),
           launch_bytes=2 * nbytes(a_w) + nbytes(nf, row_dst, thresh) + k3_plan_bytes(dev))
    check(same, "lattice_fb differs from the plain version or its alpha from K3's")


def compare_nbest_kernel(torch, device, width: Width, graph, ll_all, acwt, record, log) -> None:
    """Phase 3, K7 on the full-width graph at the sub-batch and list length
    of phase 11, fed ``ll_all`` [T, P, B] (K7's layout).  The kernel's entry
    is the main path's launch: all T frames in one window at exact search,
    held to the plain version frame by frame (one lane ends half way).  Side
    cases, each one frame a launch and as one window of the K3 frames
    against the plain window, from the start state and again after a window
    of ``nbest_warm`` frames of the kernel alone has spread the hypotheses
    (two lanes end inside the compared windows and one has no frames): at
    exact search and at the decoder's default beam, so that both branches
    of the prune on read are compared."""
    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions
    from voicebridge_tpu_torch.ops import viterbi as V

    t_all, _p, b = ll_all.shape
    k, frames = width.nbest, width.k3_frames
    plan = V.build_nbest_plan(graph, device)
    s = plan.num_states
    src = plan.src.long()
    plan_bytes = nbytes(plan.in_start, plan.src, plan.pdf, plan.score, plan.arc)
    exact = float(np.float32(EXACT_BEAM))
    alpha0 = torch.full((s, b, k), V.NEG_INF, dtype=torch.float32, device=device)
    alpha0[:, :, 0] = torch.from_numpy(graph.alpha0).to(device)[:, None]

    def tables(w):
        return (torch.empty((w, s, b, k), dtype=torch.int32, device=device),
                torch.empty((w, s, b, k), dtype=torch.int8, device=device))

    def end_rows(nf, t0, w):
        """The alpha_end bytes written by a launch over frames t0 .. t0+w-1."""
        return int(((nf > t0) & (nf <= t0 + w)).sum()) * s * k * 4

    # the main path's launch, held frame by frame to the plain version
    nf = torch.full((b,), t_all, dtype=torch.int32, device=device)
    nf[b // 2] = t_all // 2
    bp_k = tables(t_all)
    a_k, e_k = V.nbest_window(plan, alpha0, torch.full_like(alpha0, V.NEG_INF), ll_all, nf, 0,
                              acwt, exact, *bp_k)
    one = tables(1)
    a_p, e_p = alpha0, torch.full_like(alpha0, V.NEG_INF)
    same, cands = True, 0
    for t in range(t_all):
        a_last, e_last = a_p, e_p.clone()
        # candidates this frame's data needs: one per live slot of every
        # arc's source in every lane still running
        cands += int(((a_p > V.NEG_INF).sum(dim=2)[src] * (t < nf)).sum())
        a_p, e_p = V.nbest_step_plain(plan, a_p, e_p, ll_all[t], nf, t, acwt, exact,
                                      one[0][0], one[1][0])
        same = same and torch.equal(one[0][0], bp_k[0][t]) and torch.equal(one[1][0], bp_k[1][t])
    same = same and torch.equal(a_k, a_p) and torch.equal(e_k, e_p)
    a_last = a_last.contiguous()  # the plain version returns [S, B, K] views
    live = int((bp_k[0][-1] >= 0).sum())
    log(f"viterbi_nbest: {b} lanes x {k} slots x {t_all} frames in one launch at exact search "
        f"(the main path's), {live} live slots of {bp_k[0][-1].numel()} in the last frame, "
        f"{cands / t_all:.6g} candidates a frame; bit-equal to the plain version frame by "
        f"frame: {same}")
    e_t = e_k.clone()
    # a frame's backpointers and logliks; alpha in and out, the plan and the
    # alpha_end rows of the lanes that end in the launch once a launch; an
    # add and a compare per candidate, an add and a multiply per (arc, lane)
    record("viterbi_nbest", [(a_k, a_p), (e_k, e_p)],
           lambda: V.nbest_window(plan, alpha0, e_t, ll_all, nf, 0, acwt, exact, *bp_k),
           lambda: V.nbest_step_plain(plan, a_last, e_last, ll_all[-1], nf, t_all - 1, acwt,
                                      exact, one[0][0], one[1][0]),
           (nbytes(bp_k[0][0], bp_k[1][0], ll_all[0]),
            2 * cands / t_all + 2 * plan.src.numel() * b), equal=same, frames=t_all,
           frame_fn=lambda: V.nbest_step(plan, a_last, e_t, ll_all[-1], nf, t_all - 1, acwt,
                                         exact, bp_k[0][-1], bp_k[1][-1]),
           launch_bytes=2 * nbytes(alpha0) + nbytes(nf) + plan_bytes + end_rows(nf, 0, t_all),
           frame_launch_bytes=(2 * nbytes(alpha0) + nbytes(nf) + plan_bytes
                               + end_rows(nf, t_all - 1, 1)))
    del bp_k, a_k, e_k, a_p, e_p, a_last, e_last, e_t

    # the side cases: windows of the K3 frames
    ll = ll_all[:frames]
    warm = width.nbest_warm
    total = frames + warm + frames
    nf = torch.full((b,), total, dtype=torch.int32, device=device)
    for i, n in enumerate([frames // 2, frames + warm + frames // 2, 0][: b - 1]):
        nf[i + 1] = n
    end0 = torch.where((nf == 0)[None, :, None], alpha0, torch.full_like(alpha0, V.NEG_INF))
    ll_warm = ll_all[torch.arange(warm, device=device) % frames].contiguous()

    def compare(alpha, end, t0, beam):
        """Frames t0 .. t0+frames-1 from ``alpha``: per-frame launches and
        one window against the plain window; returns (alpha, alpha_end,
        equal, the window's arguments)."""
        bp = {m: tables(frames) for m in "1wp"}
        a1, e1 = alpha, end.clone()
        for i in range(frames):
            a1, e1 = V.nbest_step(plan, a1, e1, ll[i], nf, t0 + i, acwt, beam, bp["1"][0][i],
                                  bp["1"][1][i])
        args = (nf, t0, acwt, beam)
        a_w, e_w = V.nbest_window(plan, alpha, end.clone(), ll, *args, *bp["w"])
        a_p, e_p = V.nbest_window_plain(plan, alpha, end.clone(), ll, *args, *bp["p"])
        same = all(bool(torch.equal(x, y)) for x, y in (
            (a1, a_p), (a_w, a_p), (e1, e_p), (e_w, e_p), (bp["1"][0], bp["p"][0]),
            (bp["w"][0], bp["p"][0]), (bp["1"][1], bp["p"][1]), (bp["w"][1], bp["p"][1])))
        return a_w, e_w, same, (alpha, bp, args, a_p, a_w)

    default = DecodeOptions().beam
    side = f" in a {frames}-frame window"
    for beam, what in ((exact, side), (float(np.float32(default)), f"{side} at beam {default}")):
        a, e, same0, _ = compare(alpha0, end0, 0, beam)
        a, e = V.nbest_window(plan, a, e, ll_warm, nf, frames, acwt, beam, *tables(warm))
        a, e, same1, (alpha_t, bp, args, a_p, a_w) = compare(a, e, frames + warm, beam)
        same = same0 and same1
        live = int((bp["w"][0][-1] >= 0).sum())
        cands = int((alpha_t > V.NEG_INF).sum(dim=2)[src].sum())
        log(f"viterbi_nbest{what}: {b} lanes x {k} slots, {live} live slots of "
            f"{bp['w'][0][-1].numel()} after {total} frames at beam {beam}, {cands} candidates "
            f"in the timed frame; one frame a launch and one window of {frames}, bit-equal to "
            f"the plain version: {same}")
        t0 = args[1]
        e_t = e.clone()
        once = 2 * nbytes(alpha_t) + nbytes(nf) + plan_bytes
        record("viterbi_nbest", [(a_w, a_p)],
               lambda: V.nbest_window(plan, alpha_t, e_t, ll, *args, *bp["w"]),
               lambda: V.nbest_step_plain(plan, alpha_t, e_t, ll[0], nf, t0, acwt, beam,
                                          bp["p"][0][0], bp["p"][1][0]),
               (nbytes(bp["w"][0][0], bp["w"][1][0], ll[0]),
                2 * cands + 2 * plan.src.numel() * b), equal=same, frames=frames,
               frame_fn=lambda: V.nbest_step(plan, alpha_t, e_t, ll[0], nf, t0, acwt, beam,
                                             bp["1"][0][0], bp["1"][1][0]),
               launch_bytes=once + end_rows(nf, t0, frames),
               frame_launch_bytes=once + end_rows(nf, t0, 1), what=what)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the main path's table, before the phases that size by memory


def train_shape(width: Width, device, back_arcs: int = 0):
    """The full-width training shape: synthetic banded training graphs (with
    ``back_arcs`` no longer banded), the alignment set over them, features
    and frame counts (numpy seed 3)."""
    import numpy as np
    import torch

    from voicebridge_tpu_torch.steps.align import AlignmentSet
    from voicebridge_tpu_torch.testing import synth_train_graph

    rng = np.random.default_rng(3)
    graphs = [synth_train_graph(width.train_states, width.num_pdfs, rng, back_arcs)
              for _ in range(width.train_batch)]
    feats = torch.from_numpy(rng.standard_normal(
        (width.train_batch, width.train_frames, 39), dtype=np.float32)).to(device)
    nf = np.full(width.train_batch, width.train_frames, np.int32)
    return graphs, AlignmentSet(graphs, device=device), feats, nf


def device_profile(torch, fn, calls: int = 5) -> dict:
    """The device time of ``fn`` alone: the sum of the device activities
    (kernels, copies, memsets) that ``calls`` runs start under
    torch.profiler, after a run that is not read; per call, with the
    activities per call and the time by name.  Also the host's time to
    issue a run (``calls`` runs without a synchronisation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    mark = "smoke_device_profile"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == mark and e.device_type == DeviceType.CPU)
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.name != mark
           and span.start <= e.time_range.start <= span.end]
    by_name: dict = {}
    count: dict = {}
    for e in dev:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + (
            e.time_range.end - e.time_range.start) / calls / 1e3
        count[e.name[:60]] = count.get(e.name[:60], 0) + 1 / calls
    return {"device_ms": sum(by_name.values()), "host_ms": host_ms,
            "activities_per_call": len(dev) / calls, "device_ms_by_name": by_name,
            "activities_by_name": count}


def k4_sector_bytes(torch, pdf, num_frames, t_total: int, p: int, frames: int = 25) -> int:
    """The loglik bytes K4's forward must read from HBM: per utterance and
    active frame, the distinct 32-byte sectors that its states' logliks lie
    in (``pdf [B, S]``, logliks ``[B, T, P]`` f32), ``frames`` frames at a
    time on the device."""
    b = pdf.shape[0]
    utt = torch.arange(b, device=pdf.device)[:, None, None]
    sectors = 0
    for t0 in range(0, t_total, frames):
        t = torch.arange(t0, min(t0 + frames, t_total), device=pdf.device)
        at = ((utt * t_total + t[None, :, None]) * p + pdf[:, None, :].long()) // 8
        srt = at.sort(dim=2).values
        distinct = 1 + (srt[..., 1:] != srt[..., :-1]).sum(dim=2)
        sectors += int((distinct * (t[None, :] < num_frames[:, None])).sum())
    return 32 * sectors


def k6_inputs(torch, device, graphs, arcs, x_post, x_acc):
    """K6's arguments at the training shape: the features, the pdfs of the
    alignment's arcs, weights 1."""
    import numpy as np

    pdf = np.stack([graphs[i].arc_pdf[arcs[:, i]] for i in range(len(graphs))])
    return (x_post, x_acc, torch.from_numpy(pdf.reshape(-1)).to(device),
            torch.ones(x_post.shape[0], dtype=torch.float32, device=device))


def check_k6_list_and_runs(torch, w, args, num_pdfs: int, log) -> dict:
    """K6's work list built on the card against the plain one (``torch.sort``
    + ``block_table``), bit-equal; two runs of the statistics, bit-equal;
    the device activities of one call (at most 3) and its device time."""
    from voicebridge_tpu_torch.ops import gmm_stats_kernel as K6

    got, ref = K6.work_list(args[2], args[3], num_pdfs), K6.work_list_plain(args[2], args[3],
                                                                             num_pdfs)
    for name, g, r in zip(ref._fields, got, ref):
        check(bool(torch.equal(g, r)), f"gmm_stats: the card's work list differs in {name}")
    one, two = (K6.acc_stats(w, *args, num_pdfs) for _ in range(2))
    check(all(bool(torch.equal(a, b)) for a, b in zip(one, two)),
          "gmm_stats: two runs differ")
    facts = {"real_blocks": int(got.pdf_blk_hi[-1]), "list_blocks": int(got.blk_pdf.shape[0])}
    if args[0].device.type == "cuda":
        facts.update(device_profile(torch, lambda: K6.acc_stats(w, *args, num_pdfs)))
        check(facts["activities_per_call"] <= 3,
              f"gmm_stats: {facts['activities_per_call']} device activities a call "
              f"({facts['device_ms_by_name']})")
    log(f"gmm_stats: work list bit-equal to the plain one, two runs bit-equal; {facts}")
    return facts


def compare_training_kernels(torch, device, width: Width, w, record, log) -> None:
    """Phase 3, training half: K4 (forward, backtrace) and K6 against their
    plain versions at the full-width training shape; K6's work list against
    its plain version and two runs of K6 against each other."""
    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel

    graphs, aset, feats, nf_np = train_shape(width, device)
    plan = aset.band_dev
    nf = torch.from_numpy(nf_np).to(device)
    ll = gmm_kernel.loglikes_batch(feats, w)
    acwt = 0.1
    fwd = (plan.W, plan.pdf, plan.alpha0, ll, nf, acwt, plan.offsets)
    ae_k, bps_k = AB.viterbi_forward_banded(*fwd, plan.pdf_range)
    ae_p, bps_p = AB.viterbi_forward_banded_plain(*fwd)
    same = bool(torch.equal(ae_k, ae_p) and torch.equal(bps_k, bps_p))
    b, s, k = plan.W.shape
    t, p = ll.shape[1], ll.shape[2]
    # the band, the logliks' 32-byte sectors that the states' pdfs touch
    # (the loglik block does not fit in L2), the backpointers out; an add
    # and a compare per band slot, an add and a multiply per state
    plan_bytes = nbytes(plan.W, plan.pdf, plan.alpha0, nf, ae_k, bps_k)
    sector_bytes = k4_sector_bytes(torch, plan.pdf, nf, t, p)
    entry = record("align_forward", [(ae_k, ae_p)],
                   lambda: AB.viterbi_forward_banded(*fwd, plan.pdf_range),
                   lambda: AB.viterbi_forward_banded_plain(*fwd),
                   (plan_bytes + sector_bytes, 2 * b * t * s * k + 2 * b * t * s), equal=same)
    entry["bound_4byte_ms"] = 1e3 * (plan_bytes + 4 * b * t * s) / HBM_BYTES_PER_S
    entry["loglik_sector_bytes"] = sector_bytes
    if device.type == "cuda":
        entry.update(device_profile(torch, lambda: AB.viterbi_forward_banded(*fwd,
                                                                             plan.pdf_range)))
    log(f"align_forward: {sector_bytes} bytes of loglik sectors ({sector_bytes / (b * t):.0f} "
        f"a frame of {4 * p}), bound {entry['bound_ms']:.4g} ms; 4 bytes a loglik "
        f"{entry['bound_4byte_ms']:.4g} ms; device alone {entry.get('device_ms')} ms")
    del bps_p
    bt = (ae_k, plan.final, bps_k, nf, plan.offsets, plan.arc_of)
    got, ref = AB.backtrace_banded(*bt), AB.backtrace_banded_plain(*bt)
    same = all(bool(torch.equal(g, r.to(g.dtype))) for g, r in zip(got, ref))
    # the end scores, then per (frame, utterance) one backpointer, one arc
    # id looked up and one written
    entry = record("align_backtrace", [(got[3], ref[3])], lambda: AB.backtrace_banded(*bt),
                   lambda: AB.backtrace_banded_plain(*bt),
                   (nbytes(ae_k, plan.final, nf) + 9 * b * t, b * s + b * t), equal=same)
    # the staged walk reads each active frame's row of S backpointers once
    entry["bound_staged_ms"] = 1e3 * (nbytes(ae_k, plan.final, nf) + b * t * (s + 8)) \
        / HBM_BYTES_PER_S
    if device.type == "cuda":
        entry.update(device_profile(torch, lambda: AB.backtrace_banded(*bt)))
    check(bool(got[2].all()), "align_backtrace: an utterance has no path")
    one = (ae_k[:1], plan.final[:1], bps_k[:, :1].contiguous(), nf[:1], plan.offsets,
           plan.arc_of[:1])
    check(all(bool(torch.equal(x, y[:1] if y.dim() == 1 else y[:, :1]))
              for x, y in zip(AB.backtrace_banded(*one), got)),
          "align_backtrace: one utterance alone differs from the same among all")
    entry["one_utt_ms"] = cuda_ms(torch, lambda: AB.backtrace_banded(*one)) \
        if device.type == "cuda" else None
    log(f"align_backtrace: all {b} utterances {entry['ms']} ms (device alone "
        f"{entry.get('device_ms')} ms), one utterance alone {entry['one_utt_ms']} ms; bound "
        f"{entry['bound_ms']:.4g} ms by the chain's bytes, {entry['bound_staged_ms']:.4g} ms by "
        f"the staged rows")
    # forced failures: every 8th utterance loses the arc its path takes at
    # a frame in the middle, so its walk meets an empty slot there
    arc_cut = plan.arc_of.clone()
    cut = torch.arange(0, b, 8, device=device)
    taken = got[0][t // 2 + cut % 97, cut]
    arc_cut[cut] = torch.where(arc_cut[cut] == taken[:, None, None], -1, arc_cut[cut])
    bt_cut = (*bt[:5], arc_cut)
    got_c, ref_c = AB.backtrace_banded(*bt_cut), AB.backtrace_banded_plain(*bt_cut)
    same = all(bool(torch.equal(g, r.to(g.dtype))) for g, r in zip(got_c, ref_c))
    failed = torch.zeros(b, dtype=torch.bool, device=device)
    failed[cut] = True
    check(bool(torch.equal(~got_c[2], failed)),
          "align_backtrace: the forced failures did not fail exactly their utterances")
    fail_entry = record("align_backtrace", [(got_c[3], ref_c[3])],
                        lambda: AB.backtrace_banded(*bt_cut),
                        lambda: AB.backtrace_banded_plain(*bt_cut),
                        (nbytes(ae_k, plan.final, nf) + 9 * b * t, b * s + b * t), equal=same,
                        what=f" with {len(cut)} forced failures")
    entry["forced_failures_ms"] = fail_entry["ms"]
    del arc_cut, bt_cut, got_c, ref_c
    arcs = got[0].cpu().numpy()
    del ll, bps_k, bt
    x = feats.reshape(-1, feats.shape[2])
    args = k6_inputs(torch, device, graphs, arcs, x, x)
    got = gmm_stats_kernel.acc_stats(w, *args, width.num_pdfs)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(w, *args[:3], width.num_pdfs, args[3])
    # per (frame, Gaussian of its pdf): a multiply-add per row of [x, x^2]
    # for the posterior and one per dimension for each of the two sums
    entry = record("gmm_stats", list(zip(got, ref)),
                   lambda: gmm_stats_kernel.acc_stats(w, *args, width.num_pdfs),
                   lambda: gmm_kernels.acc_gmm_stats_aligned_twofeats(w, *args[:3],
                                                                      width.num_pdfs, args[3]),
                   (nbytes(w.w, *args, *got), 8 * x.shape[0] * w.max_mix * x.shape[1]))
    entry.update(check_k6_list_and_runs(torch, w, args, width.num_pdfs, log))


def compare_generic_kernels(torch, device, width: Width, w, record, log) -> None:
    """Phase 3, generic aligner: forward and backtrace against their plain
    versions at the full-width training shape, over graphs with back arcs
    (refused by the banded form), unpruned as training calls it, through the
    set's plan (``AlignmentSet.generic_dev``) as ``align_feats`` runs them."""
    import numpy as np

    from voicebridge_tpu_torch.ops import gmm_kernel
    from voicebridge_tpu_torch.ops import viterbi as V

    graphs, aset, feats, nf_np = train_shape(width, device, width.back_arcs)
    check(aset.band is None, "the graphs with back arcs fit the banded form")
    plan = aset.generic_dev
    nf = torch.from_numpy(nf_np).to(device)
    ll = gmm_kernel.loglikes_batch(feats, w)
    acwt, beam = 0.1, 1e9
    fwd = (plan, ll, nf, acwt, beam)
    plain = (*V.plan_arcs(plan), plan.alpha0, ll, nf, float(np.float32(acwt)),
             float(np.float32(beam)))
    ae_k, bps_k, codes_k = V.generic_forward(*fwd)
    ae_p, bps_p = V.viterbi_forward_batched_plain(*plain)
    codes_p = V.generic_codes_plain(bps_p, plan)
    check(codes_k is not None, "the generic aligner wrote no byte codes at full width")
    same = bool(torch.equal(ae_k, ae_p) and torch.equal(bps_k, bps_p)
                and torch.equal(codes_k, codes_p))
    b, t, p = ll.shape
    a, s = plan.in_arc.shape[1], plan.num_states
    u = plan.pdf_list.shape[1]
    log(f"generic aligner: {b} graphs of {s} states, up to {a} arcs, "
        f"{float(plan.n_pdf.float().mean()):.1f} distinct pdfs each (up to {u}), largest "
        f"in-degree read {plan.max_in_degree}")
    # the plan's rows once, the logliks of each graph's distinct pdfs (as the
    # 32-byte sectors they lie in, the block not fitting in L2; 4 bytes each
    # beside), alpha_end, the arc ids and the codes out; per (frame, arc) two
    # adds, a multiply and a compare, per (frame, state) the beam's max and
    # compare
    plan_bytes = nbytes(plan.in_start, plan.in_len, plan.in_src, plan.in_score, plan.in_lpdf,
                        plan.in_arc, plan.pdf_list, plan.n_pdf, plan.alpha0, nf, ae_k, bps_k,
                        codes_k)
    live = torch.arange(u, device=device)[None, :] < plan.n_pdf[:, None]
    sector_bytes = k4_sector_bytes(torch, torch.where(live, plan.pdf_list, plan.pdf_list[:, :1]),
                                   nf, t, p)
    n_act = nf.clamp(max=t).long()
    loglik_bytes = 4 * int((n_act * plan.n_pdf.long()).sum())
    entry = record("generic_forward", [(ae_k, ae_p)], lambda: V.generic_forward(*fwd),
                   lambda: V.viterbi_forward_batched_plain(*plain),
                   (plan_bytes + sector_bytes, 4 * b * t * a + 2 * b * t * s), equal=same)
    entry["bound_4byte_ms"] = 1e3 * (plan_bytes + loglik_bytes) / HBM_BYTES_PER_S
    entry["loglik_sector_bytes"] = sector_bytes
    if device.type == "cuda":
        entry.update(device_profile(torch, lambda: V.generic_forward(*fwd)))
        check(entry["activities_per_call"] <= 1,
              f"generic_forward: {entry['activities_per_call']} device activities a call "
              f"({entry['device_ms_by_name']})")
    log(f"generic_forward: {sector_bytes} bytes of loglik sectors ({sector_bytes / (b * t):.0f} "
        f"a frame), bound {entry['bound_ms']:.4g} ms; 4 bytes a loglik "
        f"{entry['bound_4byte_ms']:.4g} ms; device alone {entry.get('device_ms')} ms")
    del bps_p, codes_p
    bt = (plan, ae_k, bps_k, codes_k, nf)
    got = V.generic_backtrace(*bt)
    ref = V.backtrace_batched_plain(plain[0], ae_k, plan.final, bps_k, nf)
    ref_c = V.generic_backtrace_codes_plain(plan, ae_k, plan.final, codes_k, nf)
    same = all(bool(torch.equal(g, r.to(g.dtype)) and torch.equal(g, c.to(g.dtype)))
               for g, r, c in zip(got, ref, ref_c))
    # the end scores, then per (frame, utterance) one backpointer, one arc's
    # source looked up and one arc id written
    chain_bytes = 2 * nbytes(ae_k) + nbytes(nf) + 12 * b * t
    entry = record("generic_backtrace", [(got[3], ref[3])], lambda: V.generic_backtrace(*bt),
                   lambda: V.generic_backtrace_codes_plain(plan, ae_k, plan.final, codes_k, nf),
                   (chain_bytes, b * s + b * t), equal=same)
    # the staged walk reads each active frame's row of S codes once, the
    # row starts and in-arc sources, and an arc id a frame
    staged = 2 * nbytes(ae_k) + nbytes(nf, plan.in_start, plan.in_src) \
        + int(n_act.sum()) * s + 8 * b * t
    entry["bound_staged_ms"] = 1e3 * staged / HBM_BYTES_PER_S
    if device.type == "cuda":
        entry.update(device_profile(torch, lambda: V.generic_backtrace(*bt)))
        check(entry["activities_per_call"] <= 1,
              f"generic_backtrace: {entry['activities_per_call']} device activities a call")
    log(f"generic_backtrace: {entry['ms']} ms (device alone {entry.get('device_ms')} ms); bound "
        f"{entry['bound_ms']:.4g} ms by the chain's bytes, {entry['bound_staged_ms']:.4g} ms by "
        f"the staged codes")
    check(bool(got[1].all()), "generic_backtrace: an utterance has no path")


def decode_yesno(torch, device, log) -> float:
    """Phase 4: the JAX-trained Yes-No model decoded on the device.  Returns
    K2's max abs error against its plain version on the model's features."""
    from synth import make_corpus
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import compute_wer_set, load_yesno_mono

    m = load_yesno_mono()
    train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    dec = Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(beam=1e9), device=device)
    k2_err = 0.0
    for name, corpus, bound in (("test", test, 5.0), ("train", train, 2.0)):
        feats = make_features({u: w for u, (w, _) in corpus.items()},
                              {u: u for u in corpus}, opts, device=device)
        utts = sorted(feats)
        k2_err = max(k2_err, k2_check(torch, torch.cat([feats[u] for u in utts]), dec.gmm,
                                      f"the yes-no {name} features", log))
        batch, nf = pad_features(feats, utts)
        hyps = {r.utt: [m.words.sym(w) for w in r.words]
                for r in dec.decode_batch(utts, batch, nf)}
        stats = compute_wer_set({u: list(corpus[u][1]) for u in utts}, hyps)
        log(f"yes-no {name}: {stats}")
        bad = [u for u in utts if hyps[u] != m.hyps[u]]
        check(not bad, f"yes-no {name}: words differ from the reference for {bad}")
        check(stats.wer <= bound, f"yes-no {name}: WER {stats.wer} > {bound}")
    return k2_err


def lattice_yesno(torch, device, log) -> None:
    """Phase 5: the JAX-trained Yes-No model decoded into lattices on the
    device and swept over the (LMWT, WIP) grid."""
    from synth import make_corpus
    from voicebridge_tpu_torch.steps.score import score_sweep
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions
    from voicebridge_tpu_torch.lat import lattice_best_path, lattice_depth_per_frame
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import load_yesno_mono

    m = load_yesno_mono()
    train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    dopts = DecodeOptions(beam=1e9)
    dec = Decoder(m.hclg, m.trans_model, m.am, dopts, device=device)
    lmwts = list(range(dopts.min_lmwt, dopts.max_lmwt + 1))
    for name, corpus in (("test", test), ("train", train)):
        feats = make_features({u: w for u, (w, _) in corpus.items()},
                              {u: u for u in corpus}, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        sweep, lats = dec.decode_sweep_lattice(utts, batch, nf, lmwts, dopts.word_ins_penalties)
        check(len(sweep) == 33, f"yes-no {name}: the sweep has {len(sweep)} grid points")
        best = {u: [m.words.sym(w) for w in
                    lattice_best_path(lats[u], 1.0, dopts.acoustic_scale)["words"]] for u in utts}
        bad = [u for u in utts if best[u] != m.hyps[u]]
        check(not bad, f"yes-no {name}: lattice best paths differ from the reference for {bad}")
        shallow = [u for u in utts if not (lattice_depth_per_frame(lats[u]) >= 1).all()]
        check(not shallow, f"yes-no {name}: lattices with an empty frame: {shallow}")
        res = score_sweep({u: list(corpus[u][1]) for u in utts},
                          {gp: {r.utt: [m.words.sym(w) for w in r.words] for r in rs}
                           for gp, rs in sweep.items()})
        log(f"yes-no {name} lattices: {sum(lat.num_arcs for lat in lats.values())} arcs in "
            f"{len(utts)} lattices; sweep best LMWT {res.best_lmwt}, WIP {res.best_wip}: "
            f"{res.best_wer}")
        if name == "test":
            check(res.best_wer.wer <= 5.0, f"yes-no test: sweep WER {res.best_wer.wer} > 5")


def decode_full_width(torch, device, width: Width, log) -> dict:
    """Phase 7: the decoding path at full width.  Returns timing facts."""
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

    reset_launches()
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


def device_busy(torch, run, warm: bool = True) -> tuple:
    """Two runs of ``run()`` under torch.profiler, the second marked and
    read (with ``warm`` false, the marked run alone): returns its result and
    the device time by kernel and the device busy share of that run's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "smoke_profiled_run"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # after earlier large traces in one process, a trace was seen to miss
        # the device work of its first milliseconds: a run that is not read
        # goes first, and only what starts inside the marked run counts
        if warm:
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(mark):
            out = run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == mark and e.device_type == DeviceType.CPU)
    by_name: dict = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.name != mark
                and span.start <= e.time_range.start <= span.end):
            total = by_name.setdefault(e.name, [0.0, 0])
            total[0] += e.time_range.end - e.time_range.start
            total[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return out, {"wall_s": wall, "device_busy_s": busy_us / 1e6,
                 "device_busy_share": busy_us / 1e6 / wall,
                 "top_device_ms": [[name[:60], us / 1e3, count]
                                   for name, (us, count) in top]}


def profile_run(torch, run, log, what: str, host_profile: bool = True,
                warm: bool = True) -> dict:
    """Three more runs of ``run``: ``device_busy``'s two (one with ``warm``
    false), and, with ``host_profile``, one under cProfile (host time by
    function, into the log)."""
    import cProfile
    import io
    import pstats

    _, facts = device_busy(torch, run, warm)
    if host_profile:
        host = cProfile.Profile()
        host.enable()
        run()
        host.disable()
        text = io.StringIO()
        pstats.Stats(host, stream=text).sort_stats("cumulative").print_stats(30)
        log(f"host profile of one {what} run (cProfile):\n" + text.getvalue())
    return facts


def train_yesno(torch, device, log) -> dict:
    """Phase 6: the Yes-No monophone model trained on the device by the
    port, then decoded with an HCLG built from it.  Returns the launch
    counts of the training."""
    from synth import LEXICON, make_corpus
    from voicebridge_tpu_torch.config import LangOptions, MonoTrainOptions
    from voicebridge_tpu_torch.data.lang import prepare_lang
    from voicebridge_tpu_torch.fst.hclg import mkgraph
    from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
    from voicebridge_tpu_torch.lm.ngram import estimate_ngram
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
    reset_launches()
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
    """Phase 8: EM iterations at the full-width training shape.  Returns
    timing facts."""
    import copy
    import math

    import numpy as np

    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import gmm_kernels as K
    from voicebridge_tpu_torch.ops import gmm_stats_kernel
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
        last_pdf[:] = [pdf.reshape(-1)]
        occ, macc, vacc, ll = K.acc_gmm_stats_chunked(params, x, pdf.reshape(-1),
                                                      width.num_pdfs)
        am.mle_update(occ, macc, vacc)
        check(np.isfinite(ll) and np.isfinite(am.means_invvars).all(),
              "full-width training: statistics are not finite")
        return time.perf_counter() - t_start

    last_pdf: list = []  # the pdfs of the last iteration's alignment
    sub_batches = math.ceil(b / aset._batch_chunk(t, width.num_pdfs, dim,
                                                  width.train_states + 1))
    reset_launches()
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
        # K6 on the iteration's own statistics: its device activities a call
        wk = K.pack_gmm(am0, device)
        args = (x, x, torch.from_numpy(last_pdf[0]).to(device),
                torch.ones(b * t, dtype=torch.float32, device=device))
        k6 = device_profile(torch, lambda: gmm_stats_kernel.acc_stats(wk, *args,
                                                                      width.num_pdfs))
        check(k6["activities_per_call"] <= 3,
              f"full-width training: K6 made {k6['activities_per_call']} device launches a "
              f"call ({k6['device_ms_by_name']})")
        facts["gmm_stats_call"] = k6
    log(f"full-width training: {json.dumps(facts)}")
    return facts


def lattice_full_width(torch, device, width: Width, log) -> dict:
    """Phase 9: the lattice path at full width.  Returns timing facts."""
    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.lat import lattice_best_path, lattice_depth_per_frame
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import feature_scaled_am, synth_decode_graph

    waves = synth_waves(width, seed=3)
    utt2spk = {u: f"spk{i % 8}" for i, u in enumerate(sorted(waves))}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                       mel_opts=MelOptions(num_bins=23))
    dopts = DecodeOptions(acoustic_scale=1.0 / 13.0)
    t0 = time.perf_counter()
    x = torch.cat(list(make_features(waves, utt2spk, opts, device=device).values())).double()
    # Gaussians 30 times narrower than the features' spread: about -40 per
    # frame after the acoustic scale and tens of arcs per frame.  Phase 7's
    # random_am scores about -390 per frame; at a total near -4e5 the f32
    # survivor test (alpha + beta against the forward's best, in the JAX
    # package's arithmetic) drifts by more than the beam (PERF.md, section 6).
    am = feature_scaled_am(x.mean(0).cpu().numpy(), x.var(0).cpu().numpy() / 30.0,
                           width.num_pdfs, width.max_mix)
    dec = Decoder.from_dense_graph(synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs),
                                   am, dopts, device=device, row_width=8)
    # K2 on these real MFCC + CMVN + delta features at full width (phase 3
    # holds it on random ones)
    k2_err = k2_check(torch, x.float().contiguous(), dec.gmm, "the lattice phase's features",
                      log)
    del x
    setup_s = time.perf_counter() - t0

    def run():
        t_start = time.perf_counter()
        feats = make_features(waves, utt2spk, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_feats = time.perf_counter()
        lats = dec.decode_lattice(utts, batch, nf)
        return lats, utts, batch, nf, t_feats - t_start, time.perf_counter() - t_feats

    reset_launches()
    lats, utts, batch, nf, feat_s, lat_s = run()
    launches = dict(_build.launches)
    check(len(lats) == width.batch, f"{len(lats)} lattices for {width.batch} utterances")
    depth = np.stack([lattice_depth_per_frame(lats[u]) for u in utts])
    check(depth.shape == (width.batch, width.frames) and bool((depth >= 1).all()),
          "a lattice frame holds no arc")
    # the exact best path (decode_batch's search, DC.decode_best_path), its
    # arcs rescored in float64: its float32 score drifts by up to about 1e-5
    # relative over 1000 frames, the lattice's host best path does not
    acwt = dopts.acoustic_scale
    g = dec.graph
    ll = dec._loglikes(batch.contiguous())
    paths = DC.decode_best_path(g, dec.plan, dec.plan_dev, ll, np.asarray(nf.cpu()), acwt)
    arcs = np.stack([p["arcs"] for p in paths])
    check(arcs.shape == (width.batch, width.frames), "an utterance has no path of T arcs")
    pdf = torch.from_numpy(g.arc_pdf[arcs]).long().to(device)
    am = ll.gather(2, pdf[:, :, None])[..., 0].double().sum(dim=1).cpu().numpy()
    exact = (g.alpha0[g.arc_src[arcs[:, 0]]].astype(np.float64)
             + g.arc_score[arcs].astype(np.float64).sum(axis=1) + acwt * am)
    del ll, pdf
    worst, drift = 0.0, 0.0
    for u, p, e in zip(utts, paths, exact):
        got = lattice_best_path(lats[u], 1.0, acwt)["score"]
        check(abs(got - e) <= max(1e-2, 1e-5 * abs(e)),
              f"{u}: lattice best path {got} against the best path's {e}")
        worst = max(worst, abs(got - e) / abs(e))
        drift = max(drift, abs(p["score"] - e) / abs(e))
    arcs = np.array([lats[u].num_arcs for u in utts])
    walls = [feat_s + lat_s]
    for _ in range(REPEATS):
        *_, f_s, l_s = run()
        walls.append(f_s + l_s)
    audio_s = width.batch * width.frames * 0.01
    lmwts = list(range(dopts.min_lmwt, dopts.max_lmwt + 1))
    n_sweep = min(width.sweep_batch, width.batch)  # the host grid pass is slow: a part
    t0 = time.perf_counter()
    sweep, _ = dec.decode_sweep_lattice(utts[:n_sweep], batch[:n_sweep], nf[:n_sweep], lmwts,
                                        dopts.word_ins_penalties)
    sweep_s = time.perf_counter() - t0
    points = len(lmwts) * len(dopts.word_ins_penalties)
    check(len(sweep) == points and all(len(r) == n_sweep for r in sweep.values()),
          "the full-width sweep lost grid points or utterances")
    facts = {"setup_s": setup_s, "first_run_features_s": feat_s, "first_run_lattice_s": lat_s,
             "audio_s": audio_s, "runs_s": walls,
             "median_audio_s_per_s": audio_s / float(np.median(walls)), "launches": launches,
             "survivors_per_frame_mean": float(depth.mean()),
             "survivors_per_frame_max": int(depth.max()),
             "arcs_per_lattice": [int(arcs.min()), float(arcs.mean()), int(arcs.max())],
             "best_path_rel_err_max": worst, "decode_f32_rel_drift_max": drift,
             "sweep_points": points, "sweep_utts": n_sweep, "sweep_s": sweep_s,
             "k2_max_abs_err": k2_err}
    if device.type == "cuda":
        facts["profile"] = profile_run(torch, run, log, "full-width lattice decode")
    log(f"full-width lattice decode: {json.dumps(facts)}")
    # phase 20's lane-major FB and sharded decode reuse the graph, features
    # and exact best-path scores
    facts["lane"] = {"dec": dec, "batch": batch, "nf": np.asarray(nf.cpu(), np.int32),
                     "exact": exact}
    return facts


def nbest_yesno(torch, device, log) -> None:
    """Phase 10: N-best decoding of the JAX-trained Yes-No model on the
    device."""
    from synth import make_corpus
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import load_yesno_mono

    m = load_yesno_mono()
    train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    dec = Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(beam=1e9), device=device)
    for name, corpus in (("test", test), ("train", train)):
        feats = make_features({u: w for u, (w, _) in corpus.items()},
                              {u: u for u in corpus}, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        for nbest in (3, 8):
            hyps = dec.decode_nbest(utts, batch, nf, nbest=nbest, keep_arcs=True)
            check_nbest(hyps, utts, f"yes-no {name}, nbest {nbest}")
            bad = [u for u in utts if [m.words.sym(w) for w in hyps[u][0][0]] != m.hyps[u]]
            check(not bad, f"yes-no {name}, nbest {nbest}: first hypotheses differ from the "
                           f"reference for {bad}")
            log(f"yes-no {name}, nbest {nbest}: {sum(len(h) for h in hyps.values())} "
                f"hypotheses for {len(utts)} utterances")


def check_nbest(hyps: dict, utts: list, what: str) -> None:
    """Every utterance has a hypothesis, scores fall, arc sequences differ."""
    for u in utts:
        check(bool(hyps.get(u)), f"{what}: no hypothesis for {u}")
        scores = [h[1] for h in hyps[u]]
        check(all(math.isfinite(x) for x in scores), f"{what}: {u} has a score that is not finite")
        check(scores == sorted(scores, reverse=True), f"{what}: scores of {u} do not fall")
        arcs = [tuple(h[2]) for h in hyps[u]]
        check(len(set(arcs)) == len(arcs), f"{what}: two hypotheses of {u} share an arc sequence")


def nbest_full_width(torch, device, width: Width, log) -> dict:
    """Phase 11: the N-best path at full width.  Returns timing facts, and
    under ``walk`` the decoder, features and frame counts that
    ``compare_backtrace_nbest`` takes."""
    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import viterbi as V
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import feature_scaled_am, synth_decode_graph

    waves = dict(list(synth_waves(width, seed=3).items())[: width.nbest_batch])
    utt2spk = {u: f"spk{i % 8}" for i, u in enumerate(sorted(waves))}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                       mel_opts=MelOptions(num_bins=23))
    # exact search, as the Yes-No phases: with a beam the best path may be
    # pruned, and decode_batch, which it is held against, never prunes
    dopts = DecodeOptions(acoustic_scale=1.0 / 13.0, beam=EXACT_BEAM)
    t0 = time.perf_counter()
    x = torch.cat(list(make_features(waves, utt2spk, opts, device=device).values())).double()
    am = feature_scaled_am(x.mean(0).cpu().numpy(), x.var(0).cpu().numpy() / 30.0,
                           width.num_pdfs, width.max_mix)  # as phase 9
    dec = Decoder.from_dense_graph(synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs),
                                   am, dopts, device=device, row_width=8)
    # built here, not in the first decode, so that the memory free before
    # each decode_nbest is the memory free when it sizes its sub-batches
    dec._nbest_plan = V.build_nbest_plan(dec.graph, device)
    del x
    setup_s = time.perf_counter() - t0

    def run():
        t_start = time.perf_counter()
        feats = make_features(waves, utt2spk, opts, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()  # the sub-batch is sized from the free memory
        # the sub-batch decode_nbest picks, by its own rule on the same free memory
        chunk = dec._nbest_chunk(batch.shape[1], batch.shape[2], width.nbest)
        t_feats = time.perf_counter()
        hyps = dec.decode_nbest(utts, batch, nf, nbest=width.nbest, keep_arcs=True)
        return hyps, utts, batch, nf, chunk, t_feats - t_start, time.perf_counter() - t_feats

    reset_launches()
    hyps, utts, batch, nf, chunk, feat_s, nbest_s = run()
    launches = dict(_build.launches)
    sub_batches = math.ceil(len(utts) / chunk)
    if device.type == "cuda":
        check(launches["viterbi_nbest"] == launches["backtrace_nbest"] == sub_batches,
              f"K7 launched {launches['viterbi_nbest']} and backtrace_nbest "
              f"{launches['backtrace_nbest']} times for {sub_batches} sub-batches of {chunk}")
    check(len(hyps) == len(waves), f"{len(hyps)} N-best lists for {len(waves)} utterances")
    check_nbest(hyps, utts, "full-width N-best")
    check(all(len(h[2]) == width.frames for u in utts for h in hyps[u]),
          "a hypothesis is not a path of T arcs")
    best = dec.decode_batch(utts, batch, nf)
    worst = 0.0
    for u, r in zip(utts, best):
        got = hyps[u][0][1]
        check(abs(got - r.score) <= max(1e-2, 1e-5 * abs(r.score)),
              f"{u}: first hypothesis {got} against decode_batch's {r.score}")
        worst = max(worst, abs(got - r.score) / abs(r.score))
    walls = [feat_s + nbest_s]
    for _ in range(REPEATS):
        *_, f_s, n_s = run()
        walls.append(f_s + n_s)
    audio_s = len(waves) * width.frames * 0.01
    facts = {"setup_s": setup_s, "first_run_features_s": feat_s, "first_run_nbest_s": nbest_s,
             "audio_s": audio_s, "runs_s": walls,
             "sub_batches": sub_batches,
             "median_audio_s_per_s": audio_s / float(np.median(walls)), "launches": launches,
             "hypotheses_per_utt": float(np.mean([len(hyps[u]) for u in utts])),
             "first_hyp_rel_err_max": worst}
    if device.type == "cuda":
        facts["profile"] = profile_run(torch, run, log, "full-width N-best decode")
    log(f"full-width N-best decode: {json.dumps(facts)}")
    facts["walk"] = (dec, batch, nf)
    return facts


def compare_backtrace_nbest(torch, dec, batch, nf, width: Width, record, log) -> None:
    """Phase 11: ``backtrace_nbest`` against its plain version on the N-best
    tables of the first sub-batch of the full-width decode, walked from the
    end entries ``backtrace_nbest_device`` takes.  Its time for all walks
    and for one walk (a single chain of dependent loads) goes beside the
    bound, with the tables in L2 (the same walk repeated) and with the L2
    flushed (as the decode finds the tables), and the time and device
    activities of ``backtrace_nbest_device`` given the decoder's plan."""
    import numpy as np

    from voicebridge_tpu_torch.ops import viterbi as V

    device = batch.device
    if device.type == "cuda":
        torch.cuda.empty_cache()
    b = min(batch.shape[0], dec._nbest_chunk(batch.shape[1], batch.shape[2], width.nbest))
    nf_np = torch.as_tensor(nf[:b]).cpu().numpy().astype(np.int32)
    nf = torch.from_numpy(nf_np).to(device)
    plan = dec._nbest_plan
    ae, bp_arc, bp_slot = V.viterbi_nbest_forward(
        plan, dec.graph.alpha0, dec._loglikes(batch[:b].contiguous()), nf_np,
        dec.opts.acoustic_scale, dec.opts.beam, width.nbest)
    s, k = ae.shape[1:]
    c = min(4 * width.nbest, s * k)
    fidx = (ae + plan.final[None, :, None]).reshape(b, s * k).sort(dim=1, descending=True,
                                                                  stable=True)[1][:, :c]
    state, slot = (fidx // k).to(torch.int32), (fidx % k).to(torch.int32)
    walk = (plan, bp_arc, bp_slot, nf, state, slot)
    plain = (bp_arc, bp_slot, plan.arc_src, nf, state, slot)
    got, ref = V.nbest_walk(*walk), V.nbest_walk_plain(*plain)
    same = all(bool(torch.equal(x, y)) for x, y in zip(got, ref))
    check(bool(got[2].any()), "backtrace_nbest: no walk reaches the start")
    one = (plan, bp_arc[:, :1], bp_slot[:, :1], nf[:1].contiguous(), state[:1, :1].contiguous(),
           slot[:1, :1].contiguous())
    t = bp_arc.shape[0]
    steps = int((got[0] >= 0).sum())
    failed = int((~got[2]).sum())
    log(f"backtrace_nbest: {b} lanes x {c} walks x {t} frames over the phase's K7 tables, "
        f"{int(got[2].sum())} walks reach the start, {steps} steps; equal to the plain "
        f"version: {same}")
    # per step the arc and the slot read and the arc's source looked up, a
    # failed walk's last arc and slot, every (frame, walk)'s arc written; the
    # start entries in, the start states and flags out; per step an index
    # computation (three multiply-adds) and a compare
    entry = record("backtrace_nbest", [(got[0], ref[0])], lambda: V.nbest_walk(*walk),
                   lambda: V.nbest_walk_plain(*plain),
                   (9 * steps + 5 * failed + 4 * t * b * c
                    + nbytes(nf, state, slot, got[1], got[2]), 7 * steps), equal=same)
    check(all(bool(torch.equal(x, y)) for x, y in zip(V.nbest_walk(*one),
                                                      (got[0][:, :1, :1], got[1][:1, :1],
                                                       got[2][:1, :1]))),
          "backtrace_nbest: one walk alone differs from the same walk among all")
    wrapper = (dec.graph, ae, bp_arc, bp_slot, nf_np, width.nbest)
    hyps = V.backtrace_nbest_device(*wrapper, plan=plan)
    check(hyps == V.backtrace_nbest_device(*wrapper),
          "backtrace_nbest_device: the plan's hypotheses differ from those of a plan built "
          "for the call")
    if device.type == "cuda":
        warm = (plan.in_start, plan.in_base, plan.in_off, plan.arc, plan.src, plan.arc_src, nf,
                state, slot)
        entry["cold_ms"] = cuda_ms_cold(torch, lambda: V.nbest_walk(*walk), warm)
        entry["one_walk_ms"] = cuda_ms(torch, lambda: V.nbest_walk(*one))
        entry["one_walk_cold_ms"] = cuda_ms_cold(torch, lambda: V.nbest_walk(*one), warm)
        prof = device_profile(torch, lambda: V.backtrace_nbest_device(*wrapper, plan=plan))
        entry["wrapper_ms"] = prof["host_ms"]  # the call ends in its one synchronisation
        entry["wrapper_device_ms"] = prof["device_ms"]
        entry["wrapper_activities_per_call"] = prof["activities_per_call"]
        entry["wrapper_activities_by_name"] = prof["activities_by_name"]
        uploads = sum(n for name, n in prof["activities_by_name"].items() if "HtoD" in name)
        check(uploads <= 1, f"backtrace_nbest_device with the plan made {uploads} host-to-device "
                            f"copies a call (the frame counts alone are allowed)")
    log(f"backtrace_nbest: all walks {entry['ms']} ms in L2, {entry.get('cold_ms')} ms with the "
        f"L2 flushed; one walk (the chain of {t} dependent frames) {entry.get('one_walk_ms')} ms "
        f"in L2, {entry.get('one_walk_cold_ms')} ms flushed; backtrace_nbest_device with the "
        f"plan {entry.get('wrapper_ms')} ms a call, device {entry.get('wrapper_device_ms')} ms in "
        f"{entry.get('wrapper_activities_per_call')} activities "
        f"({entry.get('wrapper_activities_by_name')})")


def generic_full_width(torch, device, width: Width, log) -> dict:
    """Phase 12: generic alignment at full width.  Returns timing facts."""
    import numpy as np

    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels as K
    from voicebridge_tpu_torch.steps import align as A
    from voicebridge_tpu_torch.testing import random_am

    t0 = time.perf_counter()
    graphs, aset, feats, nf = train_shape(width, device, width.back_arcs)
    params = K.pack_gmm(random_am(width.num_pdfs, width.max_mix, 39, seed=4), device)
    why: list = []
    check(AB.build_band_plan(graphs, reason=why) is None and aset.band is None,
          "the graphs with back arcs fit the banded form")
    log(f"full-width generic alignment: build_band_plan refuses the set: {why[0]}")
    setup_s = time.perf_counter() - t0

    def run():
        t_start = time.perf_counter()
        alis = aset.align_feats(params, feats, nf, acoustic_scale=0.1)
        return alis, time.perf_counter() - t_start

    chunks: list = []  # the sub-batch size align_feats takes from the free memory
    batch_chunk = aset._batch_chunk
    aset._batch_chunk = lambda *args: chunks.append(batch_chunk(*args)) or chunks[-1]
    reset_launches()
    alis, wall = run()
    launches = dict(_build.launches)
    del aset._batch_chunk
    sub_batches = math.ceil(len(graphs) / chunks[0])
    check(all(len(r["arcs"]) == n and np.isfinite(r["score"]) for r, n in zip(alis, nf)),
          "full-width generic alignment: an utterance did not align")
    if device.type == "cuda":
        check(launches["generic_forward"] == launches["generic_backtrace"] == sub_batches,
              f"full-width generic alignment: the forward launched "
              f"{launches['generic_forward']} and the backtrace "
              f"{launches['generic_backtrace']} times for {sub_batches} sub-batches")
    back = sum(int((g.arc_dst[r["arcs"]] < g.arc_src[r["arcs"]]).sum())
               for g, r in zip(graphs, alis))
    walls = [wall] + [run()[1] for _ in range(REPEATS)]
    # a banded set through both aligners
    b_graphs, b_aset, b_feats, b_nf = train_shape(width, device)
    want = b_aset.align_feats(params, b_feats, b_nf, acoustic_scale=0.1)
    ll = gmm_kernel.loglikes_batch(b_feats, params)
    got = A._align_generic(b_aset.generic_dev, b_graphs, ll, b_nf, 0.1, 1e9)
    differ = [i for i, (g, w_) in enumerate(zip(got, want)) if g["score"] != w_["score"]]
    check(not differ, f"banded and generic aligner score utterances {differ[:8]} differently")
    # equal scores, so where the transition ids differ two best paths tie in
    # float32 (K4 takes the first band slot, the generic aligner the lowest
    # arc id): then both paths, rescored in float64, must score the same to
    # within float32's rounding over T frames
    tied = [i for i, (g, w_) in enumerate(zip(got, want)) if g["tids"] != w_["tids"]]
    for i in tied:
        g = b_graphs[i]
        a_g, a_w = (np.asarray(r[i]["arcs"]) for r in (got, want))
        ll_i = ll[i].double().cpu().numpy()
        s_g, s_w = (float(g.alpha0[g.arc_src[a[0]]]) + g.arc_score[a].astype(np.float64).sum()
                    + 0.1 * ll_i[np.arange(len(a)), g.arc_pdf[a]].sum()
                    + float(g.final_score[g.arc_dst[a[-1]]]) for a in (a_g, a_w))
        check(abs(s_g - s_w) <= max(1e-2, 1e-5 * abs(s_w)),
              f"utterance {i}: the generic aligner's path scores {s_g}, the banded one's {s_w}")
    log(f"banded against generic aligner on the banded set: equal scores for all "
        f"{len(got)} utterances; transition ids differ for {tied}, where two paths tie in "
        f"float32 and score the same in float64")
    audio_s = float(nf.sum()) * 0.01
    facts = {"setup_s": setup_s, "audio_s": audio_s, "runs_s": walls,
             "median_audio_s_per_s": audio_s / float(np.median(walls)), "launches": launches,
             "sub_batches": sub_batches, "back_arcs_taken": back, "tied_with_banded": len(tied)}
    if device.type == "cuda":
        facts["profile"] = profile_run(torch, run, log, "full-width generic alignment")
    log(f"full-width generic alignment: {json.dumps(facts)}")
    return facts


def features_other_rates(torch, device, width: Width, log) -> dict:
    """Phase 13: make_features on the device at 22.05 kHz and 48 kHz (K1 at
    1024 and 2048 points), 16 utterances of ``width.frames`` frames at each,
    against the same waves through the plain version on the CPU.  Returns,
    per rate, the launch counts and the largest difference."""
    from voicebridge_tpu_torch import FrameOptions, MelOptions, MfccOptions, _build
    from voicebridge_tpu_torch.steps.make_feats import make_features

    facts = {}
    for sr in K1_RATES:
        waves = synth_waves(dataclasses.replace(width, samp_freq=sr, batch=min(16, width.batch)),
                            seed=5)
        utt2spk = {u: f"spk{i % 4}" for i, u in enumerate(sorted(waves))}
        opts = MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0),
                           mel_opts=MelOptions(num_bins=23))
        reset_launches()
        t0 = time.perf_counter()
        feats = make_features(waves, utt2spk, opts, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        ref = make_features(waves, utt2spk, opts, device="cpu")
        err = 0.0
        for u, f in feats.items():
            check(tuple(f.shape) == (width.frames, 39) and bool(torch.isfinite(f).all()),
                  f"make_features at {sr} Hz: {u} has shape {tuple(f.shape)} or values that "
                  f"are not finite")
            got, want = f.double().cpu(), ref[u].double()
            err = max(err, float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, rtol=2e-4, atol=2e-3)),
                  f"make_features at {sr} Hz: {u} differs from the CPU by {err}")
        facts[str(int(sr))] = {"n_fft": opts.frame_opts.padded_window_size, "utts": len(feats),
                               "wall_s": wall, "max_abs_err_vs_cpu": err, "launches": launches}
        log(f"make_features at {sr} Hz ({opts.frame_opts.padded_window_size} points) on "
            f"{device}: {json.dumps(facts[str(int(sr))])}")
    return facts


def aligner_kernels(aligner: str) -> tuple:
    """The kernels of the aligner ``AlignmentSet.aligner`` names."""
    if aligner.startswith("banded"):
        return ("align_forward", "align_backtrace")
    return ("generic_forward", "generic_backtrace")


def tri_yesno(torch, device, log) -> dict:
    """Phase 14: the triphone and SAT stages on the device.  Returns, per
    part, its facts and the launch counts of its run."""
    import numpy as np

    from synth import LEXICON, SR, make_corpus, make_speaker_corpus
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MfccOptions, _build
    from voicebridge_tpu_torch.config import (FmllrDecodeOptions, LangOptions, MonoTrainOptions,
                                              TriTrainOptions)
    from voicebridge_tpu_torch.data.lang import prepare_lang
    from voicebridge_tpu_torch.fst.hclg import mkgraph
    from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
    from voicebridge_tpu_torch.lm.ngram import estimate_ngram
    from voicebridge_tpu_torch.steps.align import align_utterances
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.decode_fmllr import decode_fmllr
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats, train_lda_mllt
    from voicebridge_tpu_torch.steps.train_mono import train_mono
    from voicebridge_tpu_torch.steps.train_sat import train_sat
    from voicebridge_tpu_torch.steps.train_tri import train_tri
    from voicebridge_tpu_torch.testing import compute_wer_set, load_synth_sat, load_synth_tri2b

    def decode(dec, feats, corpus, words):
        utts = sorted(feats)
        res = dec.decode_batch(utts, *pad_features(feats, utts))
        hyps = {r.utt: [words.sym(w) for w in r.words] for r in res}
        return res, hyps, compute_wer_set({u: list(corpus[u][1]) for u in utts}, hyps)

    facts: dict = {}
    # the JAX-trained tri2b model: base features (CMVN per speaker over train
    # and test, as its recipe) -> splice + final_mat on the card -> K2, K3
    m = load_synth_tri2b()
    train, test, utt2spk = make_speaker_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    waves = {u: w for u, (w, _) in {**train, **test}.items()}
    reset_launches()
    base = make_features(waves, utt2spk, opts, deltas=None, device=device)
    feats = lda_decode_feats({u: base[u] for u in test}, m.final_mat, device=device)
    check(all(tuple(f.shape[1:]) == (40,) for f in feats.values()), "LDA features not 40-dim")
    dec = Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(beam=1e9), device=device)
    res, hyps, stats = decode(dec, feats, test, m.words)
    launches = dict(_build.launches)
    bad = [u for u in hyps if hyps[u] != m.hyps[u]]
    check(not bad, f"tri2b fixture: words differ from the JAX package's for {bad}")
    rel = max(abs(r.score - m.scores[r.utt]) / abs(m.scores[r.utt]) for r in res)
    facts["fixture"] = {"utts": len(hyps), "wer": stats.wer, "score_rel_diff_max": rel,
                        "launches": launches}
    log(f"tri2b fixture decoded on {device}: {stats}; the JAX package's words for all "
        f"{len(hyps)} test utterances, scores within {rel:.3g} relative")

    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    mono_opts = MonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                 realign_iters=tuple(range(1, 10)))

    def lm_graph(model, corpus):
        g = arpa_to_fst(estimate_ngram([ws for (_w, ws) in corpus.values()], order=2),
                        lang.words.id, lang.word_disambig_id)
        return Decoder(mkgraph(lang, model.tree, model.trans_model, g), model.trans_model,
                       model.am, DecodeOptions(beam=1e9), device=device)

    def mono_and_alignments(delta, transcripts):
        mono = train_mono(delta, transcripts, lang, mono_opts, device=device)
        return mono, align_utterances(mono.am, mono.trans_model, lang, delta, transcripts,
                                      acoustic_scale=0.1, device=device)

    # mono -> tri1 (tests/test_tri.py's corpus and options)
    tr1, te1 = make_corpus(num_train=20, num_test=8, seed=11)
    feats1 = {name: make_features({u: w for u, (w, _) in c.items()}, {u: u for u in c},
                                  MfccOptions(frame_opts=FrameOptions(samp_freq=SR,
                                                                      dither=0.0)),
                                  device=device)
              for name, c in (("train", tr1), ("test", te1))}
    transcripts1 = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in tr1.items()}
    t0 = time.perf_counter()
    mono, ali = mono_and_alignments(feats1["train"], transcripts1)
    reset_launches()
    opts1 = TriTrainOptions(num_iters=10, num_leaves=120, totgauss=300, max_iter_inc=8,
                            realign_iters=(2, 4, 6, 8))
    tri1 = train_tri(feats1["train"], transcripts1, ali, lang, opts1,
                     prev_trans_model=mono.trans_model, device=device)
    launches = dict(_build.launches)
    wall = time.perf_counter() - t0
    _, _, stats = decode(lm_graph(tri1, tr1), feats1["test"], te1, lang.words)
    facts["tri1"] = {"wer": stats.wer, "pdfs": tri1.tree.num_pdfs,
                     "gaussians": tri1.am.num_gauss,
                     "aligner": tri1.aligner, "train_s": wall,
                     "launches": launches}
    log(f"tri1 trained on {device}: {json.dumps(facts['tri1'])}; test {stats}")
    check(stats.wer <= 5.0, f"tri1 (port-trained): test WER {stats.wer} > 5")

    # mono -> tri2b (tests/test_sat_lda.py's corpus and options)
    delta = make_features(waves, utt2spk, opts, device=device)
    transcripts = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    t0 = time.perf_counter()
    mono, ali = mono_and_alignments({u: delta[u] for u in train}, transcripts)
    reset_launches()
    opts2 = TriTrainOptions(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                            realign_iters=(2, 4, 6), mllt_iters=(2, 4))
    tri2b, final_mat = train_lda_mllt({u: base[u] for u in train}, transcripts, ali, lang,
                                      opts2, prev_trans_model=mono.trans_model, device=device)
    launches = dict(_build.launches)
    wall = time.perf_counter() - t0
    check(final_mat.shape == (40, 92), f"tri2b final_mat has shape {final_mat.shape}")
    lda_test = lda_decode_feats({u: base[u] for u in test}, final_mat, device=device)
    _, _, stats = decode(lm_graph(tri2b, train), lda_test, test, lang.words)
    facts["tri2b"] = {"wer": stats.wer, "pdfs": tri2b.tree.num_pdfs,
                      "gaussians": tri2b.am.num_gauss,
                      "aligner": tri2b.aligner, "train_s": wall,
                      "launches": launches}
    log(f"tri2b trained on {device}: {json.dumps(facts['tri2b'])}; test {stats}")
    check(stats.wer <= 10.0, f"tri2b (port-trained): test WER {stats.wer} > 10")

    # SAT: the JAX-trained LDA+MLLT+SAT fixture through decode_fmllr, then
    # delta+SAT from mono and LDA+MLLT+SAT from tri2b trained on the card
    # (tests/test_sat_lda.py's options and gates)
    fmllr_opts = FmllrDecodeOptions(beam=1e9, first_beam=1e9, fmllr_min_count=50.0)

    def sat_decode(hclg, model, alimdl, feats, words):
        utts = sorted(feats)
        res, trans = decode_fmllr(hclg, model.trans_model, model.am, alimdl, lang, utts,
                                  *pad_features(feats, utts), utt2spk, fmllr_opts, device=device)
        hyps = {r.utt: [words.sym(w) for w in r.words] for r in res}
        d = trans.shape[1]
        return hyps, compute_wer_set({u: list(test[u][1]) for u in utts}, hyps), \
            float(np.abs(trans[:, :, :d] - np.eye(d)[None]).max()), trans

    ms = load_synth_sat()
    check(ms.corpus == m.corpus, "the SAT fixture's corpus is not the tri2b fixture's")
    reset_launches()
    feats = lda_decode_feats({u: base[u] for u in test}, ms.final_mat, device=device)
    hyps, stats, _, trans = sat_decode(ms.hclg, ms, ms.alimdl, feats, ms.words)
    launches = dict(_build.launches)
    bad = [u for u in hyps if hyps[u] != ms.hyps[u]]
    check(not bad, f"SAT fixture: words differ from the JAX package's for {bad}")
    want = np.stack([ms.transforms[s] for s in sorted(ms.transforms)])
    facts["sat_fixture"] = {"utts": len(hyps), "wer": stats.wer, "launches": launches,
                            "transform_max_abs_diff": float(np.abs(trans - want).max())}
    log(f"SAT fixture decoded by decode_fmllr on {device}: {json.dumps(facts['sat_fixture'])}")
    sat_opts = dict(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                    fmllr_iters=(2, 4, 6))
    lda_train = lda_decode_feats({u: base[u] for u in train}, final_mat, device=device)
    ali2 = align_utterances(tri2b.am, tri2b.trans_model, lang, lda_train, transcripts,
                            acoustic_scale=0.1, device=device)
    variants = {"delta_sat": ({u: delta[u] for u in train}, {u: delta[u] for u in test},
                              mono, ali, (3, 5, 7)),
                "lda_sat": (lda_train, lda_test, tri2b, ali2, (2, 4, 6))}
    for name, (tr_feats, te_feats, prev, prev_ali, realign_iters) in variants.items():
        t0 = time.perf_counter()
        reset_launches()
        sat = train_sat(tr_feats, utt2spk, transcripts, prev_ali, prev.am, lang,
                        TriTrainOptions(**sat_opts, realign_iters=realign_iters),
                        prev_trans_model=prev.trans_model, device=device)
        launches = dict(_build.launches)
        wall = time.perf_counter() - t0
        g = arpa_to_fst(estimate_ngram([ws for (_w, ws) in train.values()], order=2),
                        lang.words.id, lang.word_disambig_id)
        hclg = mkgraph(lang, sat.model.tree, sat.model.trans_model, g)
        _, stats, dev, _ = sat_decode(hclg, sat.model, sat.alimdl, te_feats, lang.words)
        facts[name] = {"wer": stats.wer, "transform_dev": dev, "pdfs": sat.model.tree.num_pdfs,
                       "gaussians": sat.model.am.num_gauss, "aligner": sat.model.aligner,
                       "train_s": wall, "launches": launches}
        log(f"{name} trained on {device}: {json.dumps(facts[name])}; test {stats}")
        check(stats.wer <= 10.0, f"{name} (port-trained): test WER {stats.wer} > 10")
        check(dev > 0.01, f"{name}: the transforms stay within 0.01 of the identity ({dev})")
    return facts


class IdentityTransitions:
    """The transition model of the synthetic graphs, whose transition ids
    are their pdfs (``testing.synth_train_graph``, ``synth_decode_graph``):
    what ``train_tri.e_step`` and ``m_step`` and ``decode_fmllr`` read of a
    transition model."""

    def __init__(self, num_pdfs: int):
        import numpy as np
        from types import SimpleNamespace

        self.tid2pdf = np.arange(num_pdfs, dtype=np.int32)
        self.tid2phone = np.zeros(num_pdfs, np.int32)  # one phone, not silence
        self.num_transition_ids = num_pdfs - 1
        self.tree = SimpleNamespace(num_pdfs=num_pdfs)

    def mle_update(self, stats):
        """The synthetic graphs' arc scores stay as drawn."""


def device_function(torch, name: str, pairs, fn, work, log,
                    ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """One device function of a slice held to its float64 plain version:
    each (got, ref, rtol, atol) of ``pairs`` within its tolerance (0, 0:
    bit-equal; ``atol`` a number or a tensor of one per entry), with its
    wall time of one call, its device time (CUDA events) and its bound from
    ``work`` = (bytes, operations at ``ops_per_s``, by default the float32
    rate)."""
    err, ok, errs = 0.0, True, []
    for g, r, rtol, atol in pairs:
        g = torch.as_tensor(g).double()
        r = torch.as_tensor(r).double().to(g.device)
        errs.append(float((g - r).abs().max()))
        err = max(err, errs[-1])
        ok = ok and (bool(torch.equal(g, r)) if rtol == 0 and not torch.is_tensor(atol)
                     and atol == 0 else bool(((g - r).abs() <= atol + rtol * r.abs()).all()))
    timed = torch.as_tensor(pairs[0][0]).device.type == "cuda"
    wall_ms = None
    if timed:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    byte_ms, op_ms = 1e3 * work[0] / HBM_BYTES_PER_S, 1e3 * work[1] / ops_per_s
    entry = {"max_abs_err": err, "max_abs_errs": errs,
             "tolerances": [[p[2], float(torch.as_tensor(p[3]).max())] for p in pairs],
             "wall_ms": wall_ms, "ms": cuda_ms(torch, fn) if timed else None,
             "bound_ms": max(byte_ms, op_ms),
             "bound_by": "bytes" if byte_ms >= op_ms else "operations",
             "bytes": work[0], "operations": work[1]}
    log(f"{name}: {json.dumps(entry)}")
    check(ok, f"{name} disagrees with its float64 plain version (max abs err {err})")
    return entry


def scaled_atol(atol: float, ref) -> float:
    """The CPU tests' atol for sums of their size (largest entry about 1e3),
    scaled with the largest entry of ``ref``: entries near zero are
    differences of products as large as the largest."""
    return atol * max(1.0, float(ref.abs().max()) / 1e3)


def splice64(feats, nf, ctx: int):
    """Splice's plain version: each offset's frames gathered one utterance
    at a time in float64, then side by side."""
    import torch

    out = []
    for i in range(feats.shape[0]):
        t = torch.arange(feats.shape[1], device=feats.device)
        last = max(int(nf[i]) - 1, 0)
        out.append(torch.cat([feats[i].double()[(t + o).clamp(0, last)]
                              for o in range(-ctx, ctx + 1)], dim=1))
    return torch.stack(out)


def lda_mllt_full_width(torch, device, width: Width, record, results: dict, log) -> dict:
    """Phase 15: tri2b at full width (splice +-3 of 13-dim features, LDA to
    40, the 2000 x 5 GMM).  Training half at phase 8's shape through the
    functions of ``steps/train_lda_mllt.py``; decode half at phase 7's.
    Returns timing facts."""
    import copy

    import numpy as np

    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.config import TriTrainOptions
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel
    from voicebridge_tpu_torch.ops.features import add_deltas_batch, splice_frames_batch
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.steps.train_lda_mllt import (estimate_lda_from_alignment,
                                                            lda_decode_feats, mllt_update)
    from voicebridge_tpu_torch.steps.train_tri import e_step, m_step, realign
    from voicebridge_tpu_torch.testing import feature_scaled_am, random_am, synth_decode_graph
    from voicebridge_tpu_torch.transforms import lda as L
    from voicebridge_tpu_torch.transforms import mllt as M

    gmm_tol = TOL["gmm_loglikes"]
    fns: dict = {}
    if device.type == "cuda":
        torch.cuda.empty_cache()  # earlier phases' large tables, before the float64 references
    # ---- training half ----
    graphs, aset, _, nf = train_shape(width, device)
    b, t = width.train_batch, width.train_frames
    rng = np.random.default_rng(8)
    base = torch.from_numpy(rng.standard_normal((b, t, 13), dtype=np.float32)).to(device)
    nf_t = torch.from_numpy(nf)
    # the prior alignment: K2 and K4 with the 39-dim model of phase 8 on
    # the base features' deltas
    prior_am = random_am(width.num_pdfs, width.max_mix, 39, seed=4)
    prior = aset.align_feats(gmm_kernels.pack_gmm(prior_am, device), add_deltas_batch(base, nf_t),
                             nf, acoustic_scale=0.1)
    check(all(len(r["arcs"]) == n for r, n in zip(prior, nf)), "the prior alignment failed")
    tids = np.stack([g.arc_tid[r["arcs"]] for g, r in zip(graphs, prior)]).astype(np.int32)
    weights = np.ones((b, t), np.float32)
    pdf = tids.reshape(-1)  # the synthetic graphs' transition ids are their pdfs
    spliced = splice_frames_batch(base, nf_t)
    sdim = spliced.shape[2]
    n = b * t
    fns["splice_train"] = device_function(
        torch, "splice (training shape)", [(spliced, splice64(base, nf, 3), 0.0, 0.0)],
        lambda: splice_frames_batch(base, nf_t), (4 * n * (13 + sdim), 0), log)
    x = spliced.reshape(n, sdim)
    c = width.num_pdfs
    stats = L.acc_lda_stats(x, pdf, weights.reshape(-1), c)
    ids = torch.from_numpy(pdf).to(device, torch.int64)
    x64, w64 = x.double(), torch.ones(n, dtype=torch.float64, device=device)
    ref = (torch.zeros(c, dtype=torch.float64, device=device).index_add_(0, ids, w64),
           torch.zeros((c, sdim), dtype=torch.float64, device=device).index_add_(
               0, ids, x64 * w64[:, None]), (x64 * w64[:, None]).T @ x64)
    # counts and class means rtol 1e-5, the second moment rtol 1e-5 / atol 1e-3
    # (tests/test_torch_lda_mllt.py), scaled with its largest entry
    fns["acc_lda_stats"] = device_function(
        torch, "acc_lda_stats",
        [(stats[0], ref[0], 1e-5, 1e-5), (stats[1], ref[1], 1e-5, scaled_atol(1e-5, ref[1])),
         (stats[2], ref[2], 1e-5, scaled_atol(1e-3, ref[2]))],
        lambda: L.acc_lda_stats(x, pdf, weights.reshape(-1), c),
        (4 * n * (sdim + 1) + 8 * n + 4 * c * (sdim + 1) + 4 * sdim * sdim,
         2 * n * sdim * sdim + 2 * n * sdim), log)
    del x64, ref
    cur_mat = estimate_lda_from_alignment(x, pdf, weights.reshape(-1), c)
    feats = L.apply_affine_transform(spliced, cur_mat)
    e = feats.shape[2]
    mat64 = torch.from_numpy(cur_mat).to(device).double()
    fns["apply_affine_transform_train"] = device_function(
        torch, "apply_affine_transform (training shape)",
        [(feats, spliced.double() @ mat64[:, :-1].T + mat64[:, -1], *gmm_tol)],
        lambda: L.apply_affine_transform(spliced, cur_mat),
        (4 * n * (sdim + e) + 4 * cur_mat.size, 2 * n * sdim * e), log)
    x40 = feats.reshape(n, e).double()
    am = feature_scaled_am(x40.mean(0).cpu().numpy(), x40.var(0).cpu().numpy(),
                           width.num_pdfs, width.max_mix, seed=9)
    del x40
    # acc_mllt_stats against its plain version in float64 (all-float64
    # inputs through the same chunk function, one chunk)
    params = gmm_kernels.pack_gmm(am, device)
    mllt_args = (am.means(), am.inv_vars, feats.reshape(n, e), pdf, weights.reshape(-1))
    g, beta = M.acc_mllt_stats(params, *mllt_args)
    params64 = params.to(torch.float64)
    g64, b64 = M._mllt_chunk(params64, *(torch.as_tensor(a).to(device, torch.float64)
                                         for a in mllt_args[:3]), ids,
                             torch.as_tensor(mllt_args[4]).to(device, torch.float64))
    # the least work for G: the posteriors of the k weighted (frame, live
    # Gaussian) pairs, S_g = sum over g's pairs of gamma diff diff^T (k e^2
    # multiply-adds), then G[d] = sum_g iv[g, d] S_g, one [e, G] x [G, e^2]
    # product over the live Gaussians
    live = (am.weights > 0).sum(axis=1)
    k = int(live[pdf][weights.reshape(-1) != 0].sum())
    log(f"acc_mllt_stats: largest |G| {float(g64.abs().max()):.6g}, beta {beta:.6g}")
    # G rtol 1e-4 / atol 1e-3 scaled with its largest entry, beta rtol 1e-6
    fns["acc_mllt_stats"] = device_function(
        torch, "acc_mllt_stats",
        [(g, g64, 1e-4, scaled_atol(1e-3, g64)), (torch.tensor(beta), b64.cpu(), 1e-6, 0.0)],
        lambda: M.acc_mllt_stats(params, *mllt_args),
        (4 * n * (e + 2) + 4 * am.num_pdfs * width.max_mix * (4 * e + 1) + 4 * e ** 3,
         4 * k * e + 2 * k * e * e + 2 * e * am.num_gauss * e * e), log)
    del g64, params, params64
    cur_mat, feats, impr = mllt_update(am, feats, spliced, cur_mat, pdf, weights.reshape(-1))
    log(f"MLLT at full width: objf improvement {impr:.5f} per frame")
    x = feats.reshape(n, e)
    tm = IdentityTransitions(width.num_pdfs)
    opts = TriTrainOptions()
    am0 = am

    def em_iter():
        """Realignment (K2, K4) -> E-step (K6) -> host M-step, on copies."""
        t_start = time.perf_counter()
        am = copy.deepcopy(am0)
        tids_i, w_i = tids.copy(), weights.copy()
        realign(aset, am, feats, nf, tids_i, w_i, [], opts, "full-width tri2b realign",
                [f"utt{i}" for i in range(b)])
        stats = e_step(am, tm, x, tids_i, w_i)
        m_step(am, tm, stats, am0.num_gauss, opts, seed=2001)
        check(np.isfinite(stats[4]) and np.isfinite(am.means_invvars).all(),
              "full-width tri2b: statistics are not finite")
        return time.perf_counter() - t_start, am

    for key in _build.launches:
        _build.launches[key] = 0
    wall, trained = em_iter()
    train_launches = dict(_build.launches)
    walls = [wall] + [em_iter()[0] for _ in range(REPEATS)]
    mix = (trained.weights > 0).sum(axis=1)
    log(f"full-width tri2b EM: Gaussians per pdf after the M-step {int(mix.min())}-"
        f"{int(mix.max())}")
    # K6 at D = 40 on the trained model's uneven mixture counts
    w_k = gmm_kernels.pack_gmm(trained, device)
    args = (x, x, ids.to(torch.int32), torch.ones(n, dtype=torch.float32, device=device))
    got = gmm_stats_kernel.acc_stats(w_k, *args, width.num_pdfs)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(w_k, *args[:3], width.num_pdfs, args[3])
    d40 = record("gmm_stats", list(zip(got, ref)),
                 lambda: gmm_stats_kernel.acc_stats(w_k, *args, width.num_pdfs),
                 lambda: gmm_kernels.acc_gmm_stats_aligned_twofeats(w_k, *args[:3],
                                                                    width.num_pdfs, args[3]),
                 (nbytes(w_k.w, *args, *got), 8 * n * w_k.max_mix * e),
                 what=" at D = 40, uneven mixtures")
    if device.type == "cuda":
        d40.update(device_profile(torch, lambda: gmm_stats_kernel.acc_stats(w_k, *args,
                                                                           width.num_pdfs)))
    results["gmm_stats"]["lda_features"] = {**d40, "max_mix": w_k.max_mix}
    results["gmm_loglikes"]["max_abs_err_lda_uneven"] = k2_check(
        torch, x.contiguous(), w_k, "the tri2b training features (uneven mixtures)", log)
    del got, ref, w_k
    audio_s = n * 0.01
    train = {"audio_s": audio_s, "runs_s": walls,
             "median_audio_s_per_s": audio_s / float(np.median(walls)),
             "launches": train_launches, "mllt_impr": impr,
             "mixtures": [int(mix.min()), int(mix.max())]}
    if device.type == "cuda":
        train["profile"] = profile_run(torch, lambda: em_iter()[0], log, "full-width tri2b EM")
    log(f"full-width tri2b EM iteration: {json.dumps(train)}")
    del graphs, aset, base, spliced, feats, x, args

    # ---- decode half: phase 7's waves through the serving path ----
    waves = synth_waves(width, seed=3)
    utt2spk = {u: f"spk{i % 8}" for i, u in enumerate(sorted(waves))}
    mopts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                        mel_opts=MelOptions(num_bins=23))
    t0 = time.perf_counter()
    base = make_features(waves, utt2spk, mopts, deltas=None, device=device)
    utts = sorted(base)
    bb, nfb = pad_features(base, utts)
    spliced = splice_frames_batch(bb, nfb)
    nd = spliced.shape[0] * spliced.shape[1]
    fns["splice_decode"] = device_function(
        torch, "splice (decode shape)", [(spliced, splice64(bb, nfb.cpu().numpy(), 3), 0.0, 0.0)],
        lambda: splice_frames_batch(bb, nfb), (4 * nd * (13 + sdim), 0), log)
    lda = L.apply_affine_transform(spliced, cur_mat)
    mat64 = torch.from_numpy(cur_mat).to(device).double()
    fns["apply_affine_transform_decode"] = device_function(
        torch, "apply_affine_transform (decode shape)",
        [(lda, spliced.double() @ mat64[:, :-1].T + mat64[:, -1], *gmm_tol)],
        lambda: L.apply_affine_transform(spliced, cur_mat),
        (4 * nd * (sdim + e) + 4 * cur_mat.size, 2 * nd * sdim * e), log)
    del spliced, bb
    x = lda.reshape(nd, e).contiguous()
    xd = x.double()
    am = feature_scaled_am(xd.mean(0).cpu().numpy(), xd.var(0).cpu().numpy(),
                           width.num_pdfs, width.max_mix)
    del xd
    dopts = DecodeOptions(acoustic_scale=1.0 / 13.0)
    dec = Decoder.from_dense_graph(synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs),
                                   am, dopts, device=device, row_width=8)
    setup_s = time.perf_counter() - t0
    # K2 at D = 40 on these features against its float64 plain version,
    # timed with its TF32 bound as in phase 3
    w = dec.gmm
    ll = gmm_kernel.loglikes(x, w)
    kp = gmm_kernel.k_pad(w.w.shape[2])
    d40 = record("gmm_loglikes", [(ll, k2_plain64(x, w))], lambda: gmm_kernel.loglikes(x, w),
                 lambda: gmm_kernels.loglikes(w, x),
                 (nbytes(x, w.w, ll), 3 * 2 * nd * w.num_pdfs * w.max_mix * kp),
                 ops_per_s=TF32_OPS_PER_S, what=" on the LDA features (D = 40)")
    results["gmm_loglikes"]["max_abs_err_lda_features"] = d40["max_abs_err"]
    results["gmm_loglikes"]["lda_features"] = {**d40, "k_pad": kp}
    del ll, x, lda

    def run():
        t_start = time.perf_counter()
        base = make_features(waves, utt2spk, mopts, deltas=None, device=device)
        feats = lda_decode_feats(base, cur_mat, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t_feats = time.perf_counter()
        res = dec.decode_batch(utts, batch, nf, keep_tids=True)
        return res, batch.shape, t_feats - t_start, time.perf_counter() - t_feats

    for key in _build.launches:
        _build.launches[key] = 0
    res, shape, feat_s, dec_s = run()
    launches = dict(_build.launches)
    check(tuple(shape) == (width.batch, width.frames, 40), f"LDA feature batch shape {shape}")
    check(all(len(r.tids) == width.frames for r in res), "an utterance has no path of T arcs")
    check(all(np.isfinite(r.score) for r in res), "a path score is not finite")
    walls = [feat_s + dec_s]
    for _ in range(REPEATS):
        _, _, f_s, d_s = run()
        walls.append(f_s + d_s)
    audio_s = width.batch * width.frames * 0.01
    decode = {"setup_s": setup_s, "first_run_features_s": feat_s, "first_run_decode_s": dec_s,
              "audio_s": audio_s, "runs_s": walls,
              "median_audio_s_per_s": audio_s / float(np.median(walls)), "launches": launches}
    if device.type == "cuda":
        decode["profile"] = profile_run(torch, lambda: run(), log, "full-width LDA decode")
    log(f"full-width LDA decode: {json.dumps(decode)}")
    return {"train": train, "decode": decode, "device_functions": fns, "final_mat": cur_mat}


SAT_SPEAKERS = 8  # speakers of phase 16's training and decode shapes


def fmllr_stats_check(torch, name: str, am, args: tuple, num_speakers: int, log) -> dict:
    """``acc_fmllr_stats`` on ``args`` (its positional inputs, the features
    a tensor on the device) held to ``testing.fmllr_stats_float64``: beta
    rtol 1e-6; each entry of K and G within rtol 1e-4 plus 1e-4 times the
    sum of its terms' magnitudes.  The posteriors come from float32
    log-likelihoods of up to about 1e3 (the decode's narrow GMM), whose
    rounding (about 1e3 x 2^-24) moves each term by up to about 1e-4 of
    itself, and the terms of K cancel; the CPU tests hold the statistics
    to the JAX package's at 1e-6 of the largest entry on a GMM of full
    variances.  Two runs must give the same bits.  Timed against its bound
    counted over the rows of nonzero weight (G: 2 n D E^2 operations, K:
    2 n D E, the posteriors and collapsed statistics 10 n M D); the bound
    over all rows beside it."""
    from voicebridge_tpu_torch.testing import fmllr_stats_float64
    from voicebridge_tpu_torch.transforms import fmllr as F

    params, means, inv_vars, feats, pdf, w, spk = args
    dev = feats.device
    got = F.acc_fmllr_stats(*args, num_speakers, device=dev)
    again = F.acc_fmllr_stats(*args, num_speakers, device=dev)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two runs of acc_fmllr_stats differ")
    *ref, k_abs, g_abs = fmllr_stats_float64(am, feats, pdf, w, spk, num_speakers,
                                             magnitudes=True)
    rows = int((torch.as_tensor(w) != 0).sum())
    n_all, d = feats.shape
    e = d + 1
    m = means.shape[1]

    def work(n):
        return (n * (4 * d + 16) + 4 * am.num_pdfs * m * (2 * d + 1)
                + 4 * num_speakers * (1 + d * e + d * e * e),
                2 * n * d * e * e + 2 * n * d * e + 10 * n * m * d)

    entry = device_function(
        torch, name,
        [(got[0], ref[0], 1e-6, 0.0), (got[1], ref[1], 1e-4, 1e-4 * k_abs),
         (got[2], ref[2], 1e-4, 1e-4 * g_abs)],
        lambda: F.acc_fmllr_stats(*args, num_speakers, device=dev), work(rows), log)
    b_all, o_all = work(n_all)
    entry.update(rows=n_all, rows_nonzero=rows, bound_ms_all_rows=1e3 * max(
        b_all / HBM_BYTES_PER_S, o_all / FP32_OPS_PER_S), largest_g=float(ref[2].abs().max()),
        err_over_magnitude=[float(((a.double() - r).abs() / m.clamp(min=1e-300)).max())
                            for a, r, m in ((got[1], ref[1], k_abs), (got[2], ref[2], g_abs))])
    log(f"{name}: {rows} of {n_all} rows weighted, bound over all rows "
        f"{entry['bound_ms_all_rows']:.4f} ms, largest |G| {entry['largest_g']:.6g}, error over "
        f"the terms' magnitude (K, G) {entry['err_over_magnitude']}")
    return entry


def fmllr_apply_check(torch, name: str, feats, trans, spk_of_utt, log) -> dict:
    """``apply_fmllr_batch`` held to float64 and timed against its bound
    (features in and out once, the transforms).  Tolerance: rtol 1e-6 and,
    per entry, the worst-case rounding of a float32 dot product of D terms
    plus the offset, (D + 2) 2^-24 times the sum of the terms' magnitudes."""
    from voicebridge_tpu_torch.transforms import fmllr as F

    dev = feats.device
    got = F.apply_fmllr_batch(feats, trans, spk_of_utt, device=dev)
    t64 = torch.from_numpy(trans).to(dev, torch.float64)[torch.from_numpy(spk_of_utt).to(dev)]
    x64 = feats.double()
    ref = x64 @ t64[:, :, :-1].transpose(1, 2) + t64[:, None, :, -1]
    b, t, d = feats.shape
    mag = x64.abs() @ t64[:, :, :-1].abs().transpose(1, 2) + t64[:, None, :, -1].abs()
    return device_function(torch, name, [(got, ref, 1e-6, (d + 2) * 2.0 ** -24 * mag)],
                           lambda: F.apply_fmllr_batch(feats, trans, spk_of_utt, device=dev),
                           (8 * b * t * d + 4 * trans.size + 8 * b, 2 * b * t * d * d), log)


def arc_costs_float64(torch, w, feats, j, t, pdf, chunk: int = 1 << 18):
    """Acoustic costs of lattice arcs recomputed in float64: for arc a,
    ``-logsumexp_m(gconst + miv . x - 0.5 iv . x^2)`` of pdf ``pdf[a]`` at
    frame ``t[a]`` of utterance ``j[a]`` from the GMM kernel's packed
    parameters ``w [P, M, 2D+1]``, in chunks of arcs.  Returns the costs
    and each arc's tolerance for a float32 evaluation: a sum of 2D+1 terms
    rounds by at most (2D+2) 2^-24 times the sum of their magnitudes, and
    the logsumexp moves no further than its largest such component error."""
    d = feats.shape[2]
    out, tol = [], []
    for lo in range(0, len(j), chunk):
        idx = [torch.from_numpy(a[lo:lo + chunk]).to(feats.device) for a in (j, t, pdf)]
        x = feats[idx[0], idx[1]].double()[:, None, :]  # [A, 1, D]
        wa = w[idx[2]].double()  # [A, M, 2D+1]
        lin, quad, gc = wa[..., :d] * x, wa[..., d:2 * d] * x * x, wa[..., 2 * d]
        out.append(-torch.logsumexp(lin.sum(-1) + quad.sum(-1) + gc, dim=1))
        mag = lin.abs().sum(-1) + quad.abs().sum(-1) + gc.abs()
        tol.append((2 * d + 2) * 2.0 ** -24 * torch.where(gc > -1e29, mag, 0.0).amax(dim=1))
    return torch.cat(out), torch.cat(tol)


def sat_full_width(torch, device, width: Width, record, results: dict, final_mat, log) -> dict:
    """Phase 16: SAT at full width (40-dim features, the 2000 x 5 GMM, 8
    speakers).  Training half at phase 8's shape through the functions of
    ``steps/train_sat.py``; decode half at phase 7's shape through
    ``steps/decode_fmllr.decode_fmllr``.  Returns timing facts."""
    import copy
    from types import SimpleNamespace

    import numpy as np

    from voicebridge_tpu_torch import FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.config import DecodeOptions, FmllrDecodeOptions, TriTrainOptions
    from voicebridge_tpu_torch.ops import gmm_kernels, gmm_stats_kernel
    from voicebridge_tpu_torch.steps import decode_fmllr as DF
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats
    from voicebridge_tpu_torch.steps.train_sat import alignment_model, estimate_transforms
    from voicebridge_tpu_torch.steps.train_tri import e_step, m_step, realign
    from voicebridge_tpu_torch.testing import feature_scaled_am, synth_decode_graph
    from voicebridge_tpu_torch.transforms import fmllr as F

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fns: dict = {}
    if device.type == "cuda":
        torch.cuda.empty_cache()  # earlier phases' tables, before the float64 references
    # ---- training half ----
    graphs, aset, _, nf = train_shape(width, device)
    b, t, d = width.train_batch, width.train_frames, 40
    n = b * t
    spk_of_utt = (np.arange(b) % SAT_SPEAKERS).astype(np.int32)
    spk_flat = np.repeat(spk_of_utt, t)
    rng = np.random.default_rng(16)
    # each speaker's features warped by a known affine transform near the identity
    eye = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    warp = (eye + 0.05 * rng.standard_normal((SAT_SPEAKERS, d, d + 1))).astype(np.float32)
    clean = torch.from_numpy(rng.standard_normal((b, t, d), dtype=np.float32)).to(device)
    base = F.apply_fmllr_batch(clean, warp, spk_of_utt, device=device)
    base_flat = base.reshape(n, d)
    x64 = clean.reshape(n, d).double()
    am0 = feature_scaled_am(x64.mean(0).cpu().numpy(), x64.var(0).cpu().numpy(),
                            width.num_pdfs, width.max_mix, seed=10)
    del x64, clean
    prior = aset.align_feats(gmm_kernels.pack_gmm(am0, device), base, nf, acoustic_scale=0.1)
    check(all(len(r["arcs"]) == k for r, k in zip(prior, nf)), "the SAT prior alignment failed")
    tids = np.stack([g.arc_tid[r["arcs"]] for g, r in zip(graphs, prior)]).astype(np.int32)
    weights = np.ones((b, t), np.float32)
    pdf = tids.reshape(-1)  # the synthetic graphs' transition ids are their pdfs
    # the initial estimate, piece by piece
    params = gmm_kernels.pack_gmm(am0, device)
    stat_args = (params, am0.means(), am0.inv_vars, base_flat, pdf, weights.reshape(-1),
                 spk_flat)
    fns["acc_fmllr_stats_train"] = fmllr_stats_check(
        torch, "acc_fmllr_stats (training shape)", am0, stat_args, SAT_SPEAKERS, log)
    beta, k, g = F.acc_fmllr_stats(*stat_args, SAT_SPEAKERS, device=device)
    t0 = time.perf_counter()
    trans, imprs = F.estimate_fmllr_batch(beta.cpu().numpy(), k.cpu().numpy(), g.cpu().numpy())
    estimate_s = time.perf_counter() - t0
    check(np.isfinite(trans).all() and all(i >= 0 for i in imprs),
          f"initial fMLLR: a transform is not finite or an improvement is negative {imprs}")
    # how far the estimate undoes each speaker's warp: W_s applied after warp_s
    undo = [float(np.abs(trans[s, :, :d] @ warp[s] + np.pad(trans[s, :, d:], ((0, 0), (d, 0)))
                         - eye).max()) for s in range(SAT_SPEAKERS)]
    log(f"initial fMLLR at full width: improvement per frame {imprs}, host estimate "
        f"{estimate_s:.3f} s; max |W_s o warp_s - I| per speaker {undo}")
    fns["apply_fmllr_batch_train"] = fmllr_apply_check(
        torch, "apply_fmllr_batch (training shape)", base, trans, spk_of_utt, log)
    tm = IdentityTransitions(width.num_pdfs)
    opts = TriTrainOptions()
    names = [f"utt{i}" for i in range(b)]

    def em_iter():
        """An iteration in ``fmllr_iters``: transforms re-estimated (statistics,
        row solves, projection), realignment (K2, K4), E-step (K6), host
        M-step with mixup, on copies."""
        t_start = time.perf_counter()
        am = copy.deepcopy(am0)
        tids_i, w_i = tids.copy(), weights.copy()
        trans_i, imprs_i = estimate_transforms(am, base_flat, tm.tid2pdf[tids_i.reshape(-1)],
                                               w_i.reshape(-1), spk_flat, SAT_SPEAKERS)
        feats = F.apply_fmllr_batch(base, trans_i, spk_of_utt, device=device)
        realign(aset, am, feats, nf, tids_i, w_i, [], opts, "full-width SAT realign", names)
        stats = e_step(am, tm, feats.reshape(n, d), tids_i, w_i)
        m_step(am, tm, stats, am0.num_gauss, opts, seed=3001)
        check(np.isfinite(stats[4]) and np.isfinite(am.means_invvars).all(),
              "full-width SAT: statistics are not finite")
        check(np.isfinite(trans_i).all() and all(i >= 0 for i in imprs_i),
              f"full-width SAT: a transform is not finite or an improvement is negative "
              f"{imprs_i}")
        return time.perf_counter() - t_start, am, feats, tids_i, w_i

    reset_launches()
    wall, trained, adapted, tids_1, w_1 = em_iter()
    train_launches = dict(_build.launches)
    walls = [wall] + [em_iter()[0] for _ in range(REPEATS)]
    # the speaker-independent alignment model: K6's two-feature path
    x_adapted = adapted.reshape(n, d)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    alimdl = alignment_model(trained, x_adapted, base_flat, tids_1.reshape(-1),
                             w_1.reshape(-1), width.num_pdfs, opts)
    alimdl_s = time.perf_counter() - t0
    alimdl_launches = dict(_build.launches)
    check(np.isfinite(alimdl.means_invvars).all(), "full-width alimdl is not finite")
    w_k = gmm_kernels.pack_gmm(trained, device)
    args = (x_adapted, base_flat, torch.from_numpy(tids_1.reshape(-1)).to(device, torch.int32),
            torch.from_numpy(w_1.reshape(-1)).to(device))
    got = gmm_stats_kernel.acc_stats(w_k, *args, width.num_pdfs)
    ref = gmm_kernels.acc_gmm_stats_aligned_twofeats(w_k, *args[:3], width.num_pdfs, args[3])
    entry = record("gmm_stats", list(zip(got, ref)),
                   lambda: gmm_stats_kernel.acc_stats(w_k, *args, width.num_pdfs),
                   lambda: gmm_kernels.acc_gmm_stats_aligned_twofeats(w_k, *args[:3],
                                                                      width.num_pdfs, args[3]),
                   (nbytes(w_k.w, *args, *got), 8 * n * w_k.max_mix * d),
                   what=" two features (x_post != x_acc) at D = 40")
    if device.type == "cuda":
        entry.update(device_profile(torch, lambda: gmm_stats_kernel.acc_stats(w_k, *args,
                                                                             width.num_pdfs)))
    results["gmm_stats"]["twofeats"] = {**entry, "max_mix": w_k.max_mix}
    del got, ref, w_k, args
    audio_s = n * 0.01
    train = {"audio_s": audio_s, "runs_s": walls,
             "median_audio_s_per_s": audio_s / float(np.median(walls)),
             "launches": train_launches, "alimdl_launches": alimdl_launches,
             "alimdl_s": alimdl_s, "initial_estimate_host_s": estimate_s,
             "initial_imprs": imprs, "warp_undo_max": undo}
    if device.type == "cuda":
        train["profile"] = profile_run(torch, lambda: em_iter()[0], log, "full-width SAT EM")
    log(f"full-width SAT EM iteration: {json.dumps(train)}")
    del graphs, aset, base, base_flat, adapted, x_adapted

    # ---- decode half: phase 7's waves, phase 15's final matrix ----
    waves = synth_waves(width, seed=3)
    utt2spk = {u: f"spk{i % SAT_SPEAKERS}" for i, u in enumerate(sorted(waves))}
    mopts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                        mel_opts=MelOptions(num_bins=23))
    t0 = time.perf_counter()
    feats = lda_decode_feats(make_features(waves, utt2spk, mopts, deltas=None, device=device),
                             final_mat, device=device)
    utts = sorted(feats)
    batch, nfd = pad_features(feats, utts)
    xd = batch.reshape(-1, batch.shape[2]).double()
    mean, var = xd.mean(0).cpu().numpy(), xd.var(0).cpu().numpy()
    del xd, feats
    # alimdl: Gaussians drawn on the features' scale, narrow as phase 9's so
    # the lattices stay sparse; the AM: alimdl re-estimated (K6, host
    # M-step, variances floored at alimdl's smallest, as a recipe floors
    # them at a share of the global variance) on these features from its
    # own exact best paths, as training leaves a model that fits its
    # features.  An AM drawn apart from alimdl fits nothing: its transforms
    # squeeze the features until every pdf scores alike, and the adapted
    # lattices hold most of the graph's arcs.
    graph = synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs)
    alimdl = feature_scaled_am(mean, var / 30.0, width.num_pdfs, width.max_mix, seed=12)
    si = Decoder.from_dense_graph(graph, alimdl, DecodeOptions(acoustic_scale=1.0 / 12.0),
                                  device=device)
    best = si.decode_batch(utts, batch, nfd, keep_tids=True)
    nfd = nfd.cpu().numpy()
    x_best = torch.cat([batch[i, :k] for i, k in enumerate(nfd)])
    am = copy.deepcopy(alimdl)
    occ, macc, vacc, _ll = gmm_kernels.acc_gmm_stats_chunked(
        gmm_kernels.pack_gmm(alimdl, device), x_best,
        np.concatenate([r.tids for r in best]), width.num_pdfs)  # the graph's tids are pdfs
    am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, float(var.min()) / 30.0)
    log(f"fMLLR decode AM: alimdl re-estimated on {int((occ.sum(1) > 0).sum())} pdfs of its "
        f"best paths")
    del si, best, x_best, batch
    no_silence = SimpleNamespace(silence_phone_ids=[])
    tm_decode = IdentityTransitions(width.num_pdfs)
    dopts = FmllrDecodeOptions()
    setup_s = time.perf_counter() - t0
    kept: dict = {"stats": [], "rescore": []}

    def keep_stats(*a, **kw):
        kept["stats"].append((a, kw))
        return acc_fmllr_stats(*a, **kw)

    def keep_rescore(dec, x, utts, lats):
        out = rescore_lattices(dec, x, utts, lats)
        kept["rescore"].append((dec, x, utts, lats, out))
        return out

    def run():
        t_start = time.perf_counter()
        base = make_features(waves, utt2spk, mopts, deltas=None, device=device)
        feats = lda_decode_feats(base, final_mat, device=device)
        utts = sorted(feats)
        batch, nf = pad_features(feats, utts)
        sync()
        t_feats = time.perf_counter()
        stages: dict = {}
        res, trans = DF.decode_fmllr(graph, tm_decode, am, alimdl, no_silence, utts, batch, nf,
                                     utt2spk, dopts, device=device, stage_s=stages)
        return res, trans, batch, nf, stages, t_feats - t_start, time.perf_counter() - t_feats

    acc_fmllr_stats, rescore_lattices = DF.acc_fmllr_stats, DF.rescore_lattices
    DF.acc_fmllr_stats, DF.rescore_lattices = keep_stats, keep_rescore
    try:
        reset_launches()
        res, trans, batch, nfd, stages, feat_s, dec_s = run()
        launches = dict(_build.launches)
    finally:
        DF.acc_fmllr_stats, DF.rescore_lattices = acc_fmllr_stats, rescore_lattices
    check(len(res) == len(waves) and all(np.isfinite(r.score) for r in res),
          "the fMLLR decode lost an utterance or gave a score that is not finite")
    check(all(len(r.tids) == width.frames for r in res), "an fMLLR best path has not T frames")
    check(np.isfinite(trans).all(), "a decode transform is not finite")
    # the decode's own device functions, held and timed on the inputs they had
    (sargs, _kw), _ = kept["stats"]
    fns["acc_fmllr_stats_decode"] = fmllr_stats_check(
        torch, "acc_fmllr_stats (decode shape, stage 1)", am, sargs[:7], sargs[7], log)
    speakers = sorted(set(utt2spk.values()))
    spk_utt = np.array([speakers.index(utt2spk[u]) for u in sorted(waves)], np.int32)
    fns["apply_fmllr_batch_decode"] = fmllr_apply_check(
        torch, "apply_fmllr_batch (decode shape)", batch, trans, spk_utt, log)
    (dec, x2, utts, lats, out), = kept["rescore"]
    j, tt, pp = DF.survivor_index([lats[u] for u in utts], dec.graph.arc_pdf)
    got = torch.from_numpy(np.concatenate([out[u].acoustic_cost for u in utts])).to(device)
    ref, tol = arc_costs_float64(torch, dec.gmm.w, x2, j, tt, pp)
    ll = dec._loglikes(x2.contiguous())
    idx = [torch.from_numpy(a).to(device) for a in (j, tt, pp)]
    fns["survivor_gather"] = device_function(
        torch, "stage-4 survivor gather", [(got, ref, 0.0, tol)],
        lambda: -ll[idx[0], idx[1], idx[2]], (len(j) * (3 * 8 + 4 + 4), 0), log)
    fns["survivor_gather"]["arcs"] = len(j)
    del ll, idx, ref, got, kept
    audio_s = len(waves) * width.frames * 0.01
    decode = {"utts": len(waves), "setup_s": setup_s, "first_run_features_s": feat_s,
              "first_run_decode_s": dec_s, "stage_s": stages, "audio_s": audio_s, "runs_s": [feat_s + dec_s],
              "median_audio_s_per_s": audio_s / (feat_s + dec_s), "launches": launches,
              "arcs_per_lattice": [int(min(lats[u].num_arcs for u in utts)),
                                   len(j) / len(utts), int(max(lats[u].num_arcs for u in utts))]}
    if device.type == "cuda":
        # stage_s splits the host's part; two runs in all (the marked run
        # alone: a trace that misses the first milliseconds of a 130 s run
        # moves its busy share by less than its run-to-run spread)
        decode["profile"] = profile_run(torch, run, log, "full-width fMLLR decode",
                                        host_profile=False, warm=False)
    log(f"full-width fMLLR decode: {json.dumps(decode)}")
    return {"train": train, "decode": decode, "device_functions": fns}


def aligner_of(launches: dict) -> str:
    """Which aligner a run's launches show (none on the CPU)."""
    took = [name for name, k in (("banded", "align_forward"), ("generic", "generic_forward"))
            if launches.get(k)]
    return "+".join(took) or "none launched"


def check_decode_artifacts(out: Path, utts: list) -> int:
    """A ``Project.decode(..., out_name=)`` directory: every file there,
    every CTM row of positive duration, no two rows of an utterance
    overlapping, and the CTM's words those of ``transcription.txt`` for
    every utterance of ``utts``.  Returns the CTM's rows."""
    for f in ("transcription.txt", "wer_table.txt", "per_utt_details.txt",
              "lattice_depth.txt", "ctm"):
        check((out / f).exists(), f"{out}: no {f}")
    ctm: dict = {}
    last_end: dict = {}
    rows = (out / "ctm").read_text().splitlines()
    for line in rows:
        utt, _chan, start, dur, word = line.split()
        start, dur = float(start), float(dur)
        check(dur > 0, f"{out}/ctm: a row of duration {dur}: {line}")
        check(start >= last_end.get(utt, 0.0) - 1e-6, f"{out}/ctm: overlapping rows at {line}")
        last_end[utt] = start + dur
        ctm.setdefault(utt, []).append(word)
    trans = {}
    for line in (out / "transcription.txt").read_text().splitlines():
        utt, *words = line.split()
        trans[utt] = words
    check(sorted(trans) == sorted(utts), f"{out}: transcription.txt lacks utterances")
    bad = [u for u in utts if ctm.get(u, []) != trans[u]]
    check(not bad, f"{out}: the CTM's words differ from transcription.txt for {bad}")
    return len(rows)


def project_examples(torch, device, work: Path, log) -> dict:
    """Phase 17: ``examples/yesno_synthetic_torch.main`` and
    ``examples/full_pipeline_synthetic_torch.main`` on the device, then the
    Yes-No project reopened and decoded with ``out_name``.  Returns, per
    example, its WERs, wall time and launch counts."""
    import importlib

    from voicebridge_tpu_torch.config import DecodeOptions, FrameOptions, MfccOptions
    from voicebridge_tpu_torch.project import Project

    sys.path.insert(0, str(ROOT / "examples"))
    facts: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    res = importlib.import_module("yesno_synthetic_torch").main(str(work / "yesno"),
                                                                device=device)
    facts["yesno"] = {"wer": res.best_wer.wer, "wall_s": time.perf_counter() - t0,
                      "launches": launch_counts()}
    check(res.best_wer.wer <= 10.0, f"the Yes-No example: WER {res.best_wer.wer} > 10")
    # the same project reopened: each stage loads what the example wrote
    reset_launches()
    proj = Project(work / "yesno", waves_dir=work / "yesno" / "waves", name="yesno",
                   device=device)
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=1)
    proj.make_features(MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=0.0)))
    mono = proj.load_model("mono")
    again = proj.decode(mono, proj.mkgraph(mono, "mono"), opts=DecodeOptions(beam=1e9),
                        out_name="mono")
    check(again.best_wer.wer == res.best_wer.wer,
          f"the reopened Yes-No project decodes to {again.best_wer}, not {res.best_wer}")
    facts["yesno"]["ctm_rows"] = check_decode_artifacts(proj.exp_dir / "mono" / "decode",
                                                        proj.test_data.utts)
    facts["yesno_reopened"] = {"launches": launch_counts()}
    log(f"phase 17, Yes-No example on {device}: {json.dumps(facts['yesno'])}")

    reset_launches()
    t0 = time.perf_counter()
    res = importlib.import_module("full_pipeline_synthetic_torch").main(str(work / "full"),
                                                                        device=device)
    facts["full_pipeline"] = {"wer": {k: r.best_wer.wer for k, r in res.items()},
                              "jax_wer": JAX_FULL_PIPELINE_WER,
                              "wall_s": time.perf_counter() - t0,
                              "launches": launch_counts()}
    log(f"phase 17, full-pipeline example on {device}: {json.dumps(facts['full_pipeline'])}")
    for stage, wer in facts["full_pipeline"]["wer"].items():
        check(wer <= 10.0, f"the full-pipeline example: {stage} WER {wer} > 10")
        # tri2b's LDA keeps 40 rows from 30 live classes: the rows past the
        # between-class rank are arbitrary null directions, which the CPU's
        # plain versions draw otherwise (9.375 %, PERF.md section 6); on the
        # CPU that comparison is reported, not applied
        if stage == "tri2b" and device.type != "cuda":
            continue
        check(wer <= JAX_FULL_PIPELINE_WER[stage] + 2.0,
              f"the full-pipeline example: {stage} WER {wer} is more than 2 points "
              f"above the JAX package's {JAX_FULL_PIPELINE_WER[stage]}")
    return facts


def graph_facts(hclg, dec, bwd) -> dict:
    """States, arcs and both decode plans' rows, row width D and most rows
    of one state (a warp of K3 or K5 walks a state's rows) of an HCLG, from
    its decoder's graph and forward plan and the lattice's backward plan."""
    import numpy as np

    fwd = dec.plan
    return {"states": hclg.num_states, "arcs": hclg.num_arcs,
            "eps_free_arcs": dec.graph.num_arcs,
            "max_in_degree": int(np.bincount(dec.graph.arc_dst).max()),
            "plan_rows": fwd.num_rows, "plan_d": fwd.d,
            "plan_max_rows_per_state": int(np.diff(fwd.row_start).max()),
            "backward_plan_rows": bwd.num_rows, "backward_plan_d": bwd.d,
            "backward_plan_max_rows_per_state": int(np.diff(bwd.row_start).max())}


def hclg_parity(torch, device, hclg, model, feats_by_utt: dict, log) -> dict:
    """Phase 18: over an HCLG that ``mkgraph`` built, the lattice
    forward-backward (K3 forward and backward, K5) and the best path (K3,
    ``backtrace_best``) on ``device`` and on the CPU (the plain versions),
    from the same loglikes (K2 on ``device``), for the test utterances of
    ``feats_by_utt``: survivors, totals, end scores and best paths must be
    bit-equal.  Returns the graph's facts."""
    import numpy as np

    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import lattice as LAT
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import pad_features

    utts = sorted(feats_by_utt)
    feats, nf = pad_features(feats_by_utt, utts)
    nf = np.asarray(nf.cpu())
    out: dict = {}
    for dev in (device, torch.device("cpu")):
        dec = Decoder(hclg, model.trans_model, model.am, device=dev)
        if "ll" not in out:
            out["ll"] = dec._loglikes(feats.to(dev).contiguous())
        ll = out["ll"].to(dev)
        acwt = dec.opts.acoustic_scale
        _f, _fd, bwd_plan, bwd_dev, row_dst = LAT.build_lattice_plans(dec.graph,
                                                                     fwd_plan=dec.plan, device=dev)
        surv, best, end, use_final = LAT.lattice_forward_backward_rows(
            dec.graph, dec.plan, dec.plan_dev, bwd_plan, bwd_dev,
            torch.from_numpy(row_dst).to(dev), ll, nf, acoustic_scale=acwt,
            lattice_beam=dec.opts.lattice_beam)
        paths = DC.decode_best_path(dec.graph, dec.plan, dec.plan_dev, ll, nf, acwt)
        out[dev.type] = ([x.cpu() for x in (surv.utt, surv.t, surv.arc, best, end)],
                         [np.asarray(torch.as_tensor(use_final).cpu()), surv.counts],
                         [(list(p["arcs"]), p["score"]) for p in paths])
        if dev == device:
            facts = graph_facts(hclg, dec, bwd_plan)
    (dev_t, dev_np, dev_paths), (cpu_t, cpu_np, cpu_paths) = out[device.type], out["cpu"]
    names = ("survivor lanes", "survivor frames", "survivor arcs", "totals", "end scores")
    differ = [n for n, a, b in zip(names, dev_t, cpu_t) if not torch.equal(a, b)]
    differ += [n for n, a, b in zip(("use_final", "survivor counts"), dev_np, cpu_np)
               if not np.array_equal(a, b)]
    differ += [f"best path of {u}" for u, a, b in zip(utts, dev_paths, cpu_paths) if a != b]
    check(not differ, f"phase 18: over the {hclg.num_states}-state HCLG the card and the "
          f"plain versions differ in {differ[:8]}")
    facts["parity"] = {"utts": len(utts), "frames": int(nf.sum()),
                       "survivors": int(cpu_np[1].sum())}
    return facts


def generic_parity(torch, device, proj, model, n_utts: int, log) -> dict:
    """Phase 18: one generic-aligner sub-batch (forward and backtrace) over
    ``model``'s training graphs of the ``n_utts`` training utterances with
    the most graph states, on ``device`` and on the CPU (the plain
    versions) from the same loglikes: alignments and scores bit-equal."""
    import numpy as np

    from voicebridge_tpu_torch.config import TriTrainOptions
    from voicebridge_tpu_torch.ops import gmm_kernel
    from voicebridge_tpu_torch.ops.gmm_kernels import pack_gmm
    from voicebridge_tpu_torch.steps import align as A
    from voicebridge_tpu_torch.steps.make_feats import pad_features
    from voicebridge_tpu_torch.steps.train_tri import training_graphs

    opts = TriTrainOptions()
    feats_by_utt = proj.feats("train", "delta")
    utts = sorted(feats_by_utt)
    aset = training_graphs(proj.lang, model.tree, model.trans_model, proj.transcripts(),
                           utts, opts, device, "phase 18")
    pick = sorted(np.argsort([-g.num_states for g in aset.graphs], kind="stable")[:n_utts])
    graphs = [aset.graphs[i] for i in pick]
    feats, nf = pad_features(feats_by_utt, [utts[i] for i in pick])
    ll = gmm_kernel.loglikes_batch(feats.to(device).contiguous(), pack_gmm(model.am, device))
    got = {}
    for dev in (device, torch.device("cpu")):
        sub = A.AlignmentSet(graphs, device=dev)
        got[dev.type] = [(list(r["arcs"]), r["score"]) for r in A._align_generic(
            sub.generic_dev, graphs, ll.to(dev), np.asarray(nf.cpu()), opts.acoustic_scale, 1e9)]
    differ = [utts[i] for i, a, b in zip(pick, got[device.type], got["cpu"]) if a != b]
    check(not differ, f"phase 18: the generic aligner on the card and its plain version align "
          f"{differ[:8]} differently over the tri1 training graphs")
    return {"utts": len(graphs), "frames": int(nf.sum()),
            "states": [min(g.num_states for g in graphs), max(g.num_states for g in graphs)],
            "band_refusal": None if aset.band is not None else aset.band_refusal}


def reopen_librispeech(work: Path, device):
    """Phase 18's project reopened: each stage loads what the example wrote."""
    from voicebridge_tpu_torch.config import FrameOptions, MfccOptions
    from voicebridge_tpu_torch.project import Project

    proj = Project(work, waves_dir=work / "waves", ref_dict=work / "ref_dict.txt",
                   name="librispeech_shaped", device=device)
    proj.prepare_data(percentage_train=round(100 * LS_UTTS / (LS_UTTS + LS_TEST_PER)),
                      order_ngram=3, idtype=0)
    proj.prepare_dict_and_lang()
    proj.make_features(MfccOptions(frame_opts=FrameOptions(samp_freq=16000.0, dither=1.0)))
    return proj


def project_librispeech(torch, device, work: Path, log) -> dict:
    """Phase 18: ``examples/librispeech_shaped_torch.py`` on ``LS_SPEAKERS``
    x (``LS_UTTS`` + ``LS_TEST_PER``) utterances, then the project reopened
    for the card-against-plain checks over its graphs.  Returns the
    example's report with each stage's launch counts, the graphs' facts, the
    aligner each stage took and a profiled decode's device busy share."""
    import contextlib
    import importlib

    import numpy as np

    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.utils.profiling import StageTimer

    launches: dict = {}

    class LaunchTimer(StageTimer):
        """A StageTimer that also sums each stage's launch counts."""

        @contextlib.contextmanager
        def stage(self, name: str, audio_s: float = 0.0):
            reset_launches()
            with super().stage(name, audio_s):
                yield
            total = launches.setdefault(name, {})
            for k, n in launch_counts().items():
                if n:
                    total[k] = total.get(k, 0) + n

    sys.path.insert(0, str(ROOT / "examples"))
    importlib.import_module("librispeech_shaped_torch").main(
        [str(work), "--speakers", str(LS_SPEAKERS), "--utts", str(LS_UTTS),
         "--test-per", str(LS_TEST_PER), "--device", str(device)], timer=LaunchTimer())
    facts = json.loads((work / "report.json").read_text())
    facts["launches"] = launches
    facts["aligner"] = {name: aligner_of(n) for name, n in launches.items()
                        if name.startswith(("train_", "align_"))}
    proj = reopen_librispeech(work, device)
    for name in ("mono", "tri1", "tri2b"):
        facts[f"ctm_rows_{name}"] = check_decode_artifacts(
            proj.exp_dir / name / "decode", proj.test_data.utts)
    models = {name: proj.load_model(name) for name in ("mono", "tri1")}
    graphs = {name: proj.mkgraph(m, name) for name, m in models.items()}
    test = proj.feats("test", "delta")
    few = sorted(test, key=lambda u: -test[u].shape[0])[:LS_PARITY_UTTS]
    t0 = time.perf_counter()
    facts["graphs"] = {name: hclg_parity(torch, device, graphs[name], m,
                                         {u: test[u] for u in few}, log)
                       for name, m in models.items()}
    facts["generic_parity"] = generic_parity(torch, device, proj, models["tri1"],
                                             LS_PARITY_UTTS, log)
    facts["parity_s"] = time.perf_counter() - t0
    # every test utterance gets a finite best path over the tri1 graph
    tri1, hclg1 = models["tri1"], graphs["tri1"]
    utts, feats, nf = proj._test_batch(test)
    paths = Decoder(hclg1, tri1.trans_model, tri1.am, device=device).decode_batch(utts, feats,
                                                                                  nf)
    check(len(paths) == len(utts) and all(np.isfinite(r.score) for r in paths),
          "phase 18: a test utterance has no finite best path over the tri1 graph")
    facts["test_frames"] = [int(nf.max()), int(nf.sum())]
    if device.type == "cuda":  # more decodes, profiled
        again, facts["decode_profile"] = device_busy(torch, lambda: proj.decode(tri1, hclg1))
        check(round(again.best_wer.wer, 2) == facts["wer"]["tri1"]["wer"],
              f"phase 18: the profiled tri1 decode gives {again.best_wer}, not "
              f"{facts['wer']['tri1']}")
    log(f"phase 18, Project at LibriSpeech-shaped width on {device}: {json.dumps(facts)}")
    # the card runs LS_SPEAKERS, where the JAX package's WERs are known; a
    # rehearsal on the CPU may run fewer speakers, and does not compare
    if device.type == "cuda":
        for name, w in facts["wer"].items():
            check(w["wer"] <= JAX_LIBRISPEECH_WER[name] + 2.0,
                  f"phase 18: {name} WER {w['wer']} is more than 2 points above the JAX "
                  f"package's {JAX_LIBRISPEECH_WER[name]}")
    return facts


PITCH_UTTS = 32  # phase 19's make_features(pitch=True) utterances (pitch is host work)
REGTREE_CLASSES = 8  # base classes of phase 19's regression tree
FULL_UBM = (1, 512)  # phase 19's full-covariance GMM, pdfs x Gaussians (train_full_ubm.sh)


def float64_tables(tables):
    """K1's tables with the plain version's float arrays in float64."""
    return dataclasses.replace(tables, **{f: getattr(tables, f).double()
                                          for f in ("window", "mel_t", "dct_t", "lifter")})


def frontends_full_width(torch, device, width: Width, record, results: dict, log) -> dict:
    """Phase 19, features: phase 7's waves through ``PlpExtractor`` (its
    defaults: K1 in ``mel_power`` mode, then the PLP tail in torch),
    ``FbankExtractor`` at 40 bins (K1 in ``fbank`` mode) and
    ``SpectrogramExtractor``, counted; then K1's ``mel_power`` rows (as logs
    floored at FLT_EPS, and the log energy) and ``fbank`` rows held to
    their plain versions in float64, the PLP tail and the spectrogram to
    float64 versions, each timed against its bound.  Then
    ``make_features(pitch=True)`` on the first ``PITCH_UTTS`` waves against
    the CPU.  Returns the launch counts, walls and device functions."""
    import numpy as np

    from voicebridge_tpu_torch.config import FrameOptions, MelOptions, MfccOptions, PlpOptions
    from voicebridge_tpu_torch.ops import features, mfcc_kernel
    from voicebridge_tpu_torch.steps.make_feats import make_features

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    waves = synth_waves(width)
    wave_t = torch.from_numpy(np.stack(list(waves.values()))).to(device)
    ns = torch.full((width.batch,), wave_t.shape[1])
    fo = FrameOptions(samp_freq=width.samp_freq, dither=0.0)
    exts = {"plp": features.PlpExtractor(PlpOptions(frame_opts=fo), device=device),
            "fbank": features.FbankExtractor(MfccOptions(frame_opts=fo,
                                                         mel_opts=MelOptions(num_bins=40)),
                                             device=device),
            "spectrogram": features.SpectrogramExtractor(MfccOptions(frame_opts=fo),
                                                         device=device)}
    reset_launches()
    t0 = time.perf_counter()
    outs = {name: ext.batched(wave_t, ns, width.frames) for name, ext in exts.items()}
    sync()
    facts = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
             "audio_s": width.batch * width.frames * 0.01}
    for name, (f, c) in outs.items():
        check(tuple(f.shape) == (width.batch, width.frames, exts[name].dim)
              and bool((c == width.frames).all()) and bool(torch.isfinite(f).all()),
              f"phase 19: {name} features of shape {tuple(f.shape)} or not finite")
    del outs
    # the card against float64, one call each outside the counted run
    frames = features.extract_frames(wave_t, width.frames, fo).reshape(-1, fo.window_size)
    frames = frames.contiguous()
    n, ws, n_fft = frames.shape[0], fo.window_size, fo.padded_window_size
    eps = features.FLT_EPS

    def logs(rows):
        return torch.cat([torch.log(rows[:, :-1].double().clamp_min(eps)),
                          rows[:, -1:].double()], dim=1)

    plp = exts["plp"].tables
    got = mfcc_kernel.mfcc_frames(frames, plp.k1)
    ref64 = features.mfcc_from_frames(frames.double(), float64_tables(plp.k1))
    record("mfcc_mel_power", [(logs(got), logs(ref64))],
           lambda: mfcc_kernel.mfcc_frames(frames, plp.k1),
           lambda: features.mfcc_from_frames(frames, plp.k1),
           (nbytes(frames, got), k1_ops(n, ws, n_fft, plp.k1)))
    p64 = features.PlpTables(plp.opts, float64_tables(plp.k1), plp.eql.double(),
                             plp.idft.double(), plp.lifter.double())
    nb, nc = plp.opts.mel_opts.num_bins, plp.opts.num_ceps
    order = plp.opts.lpc_order
    fns = {"plp_tail": device_function(
        torch, "plp_tail", [(features.plp_tail(got, plp), features.plp_tail(ref64, p64),
                             *TOL["mfcc_frames"])],
        lambda: features.plp_tail(got, plp),
        # rows in, features out; per frame the weights and compression, the
        # IDFT product, Levinson-Durbin and the cepstrum recursion
        (nbytes(got) + 4 * n * nc, n * (3 * nb + 2 * (order + 1) * (nb + 2)
                                        + 6 * order * order + 2 * nc)), log)}
    del got, ref64
    fb = exts["fbank"].tables
    got = mfcc_kernel.mfcc_frames(frames, fb)
    ref64 = features.mfcc_from_frames(frames.double(), float64_tables(fb))
    results["mfcc_frames"]["modes"] = {"fbank_40_bins": record(
        "mfcc_frames", [(got, ref64)], lambda: mfcc_kernel.mfcc_frames(frames, fb),
        lambda: features.mfcc_from_frames(frames, fb),
        (nbytes(frames, got), k1_ops(n, ws, n_fft, fb)), what=" in fbank mode, 40 bins")}
    del got, ref64
    spec = exts["spectrogram"]
    # as powers, rtol 2e-4 plus 1e-5 of the frame's largest bin: a float32
    # FFT rounds on the scale of the frame's power, so the log of a bin far
    # below it (the DC bin after DC removal) is ill-conditioned
    got = features.spectrogram_from_frames(frames, spec.opts, spec.window)
    ref = features.spectrogram_from_frames(frames.double(), spec.opts,
                                           spec.window.double()).exp()
    fns["spectrogram"] = device_function(
        torch, "spectrogram", [(got.double().exp(), ref, 2e-4, 1e-5 * ref.amax(1, keepdim=True))],
        lambda: features.spectrogram_from_frames(frames, spec.opts, spec.window),
        (nbytes(frames, got), n * (5 * ws + 5 * n_fft * math.log2(n_fft) + 4 * (n_fft // 2))),
        log)
    del got, ref, frames, wave_t
    # pitch: host work per utterance, pasted onto the card's MFCC before CMVN
    sub = {u: waves[u] for u in sorted(waves)[:PITCH_UTTS]}
    utt2spk = {u: f"spk{i % SAT_SPEAKERS}" for i, u in enumerate(sub)}
    opts = MfccOptions(frame_opts=fo)
    reset_launches()
    t0 = time.perf_counter()
    pitched = make_features(sub, utt2spk, opts, device=device, pitch=True)
    sync()
    facts["pitch"] = {"utts": len(sub), "wall_s": time.perf_counter() - t0,
                      "launches": launch_counts(), "audio_s": len(sub) * width.frames * 0.01}
    cpu = make_features(sub, utt2spk, opts, device="cpu", pitch=True)
    err = 0.0
    for u, f in pitched.items():
        got, want = f.double().cpu(), cpu[u].double()
        # the pitch track ends before the MFCC frames do (its window is
        # longer): paste-feats keeps the shorter
        check(got.shape == want.shape and got.shape[1] == 48 and got.shape[0] > 0,
              f"phase 19: make_features(pitch=True) gives {tuple(got.shape)} for {u}")
        err = max(err, float((got - want).abs().max()))
        check(bool(torch.allclose(got, want, rtol=2e-4, atol=2e-3)),
              f"phase 19: make_features(pitch=True) differs from the CPU by {err} on {u}")
    facts["pitch"]["max_abs_err_vs_cpu"] = err
    facts["device_functions"] = fns
    shown = {k: v for k, v in facts.items() if k != "device_functions"}
    log(f"phase 19, features on {device}: {json.dumps(shown)}")
    return facts


def regtree_stats_float64(torch, am, x, pdf, w, bclass_of, num_classes: int):
    """``acc_regtree_fmllr_stats``'s float64 version: per class c, the
    posteriors of each row's pdf's Gaussians in c, then beta, K and G as one
    product each over the rows; with each entry's sum of the terms'
    magnitudes (the scale of a float32 sum's rounding)."""
    import numpy as np

    dev = x.device
    x = x.double()
    pdf = torch.as_tensor(pdf).to(dev, torch.int64)
    w = torch.as_tensor(w).to(dev, torch.float64)
    miv = torch.from_numpy(am.means_invvars).to(dev, torch.float64)[pdf]
    iv = torch.from_numpy(am.inv_vars).to(dev, torch.float64)[pdf]
    gc = torch.from_numpy(np.where(np.isfinite(am.gconsts), am.gconsts, -np.inf)).to(
        dev, torch.float64)[pdf]
    gamma = torch.softmax(gc + (miv * x[:, None]).sum(-1) - 0.5 * (iv * x[:, None] ** 2).sum(-1),
                          dim=1) * w[:, None]
    cls = torch.from_numpy(np.asarray(bclass_of)).to(dev, torch.int64)[pdf]
    xhat = torch.cat([x, x.new_ones((len(x), 1))], dim=1)
    n, d = x.shape
    out = [x.new_zeros(num_classes), x.new_zeros((num_classes, d, d + 1)),
           x.new_zeros((num_classes, d, d + 1, d + 1)), x.new_zeros((num_classes, d, d + 1)),
           x.new_zeros((num_classes, d, d + 1, d + 1))]
    for c in range(num_classes):
        gq = torch.where(cls == c, gamma, 0.0)
        w_miv, w_iv = (gq[:, :, None] * miv).sum(1), (gq[:, :, None] * iv).sum(1)
        out[0][c] = gq.sum()
        for i, f in ((1, lambda a: a), (3, torch.abs)):
            out[i][c] = f(w_miv).T @ f(xhat)
            out[i + 1][c] = ((w_iv[:, :, None] * f(xhat)[:, None, :]).reshape(n, -1).T
                             @ f(xhat)).view(d, d + 1, d + 1)
    return out


def adaptation_full_width(torch, device, width: Width, log) -> dict:
    """Phase 19, adaptation at phase 16's shape: a 2000 x 5 x 40 GMM,
    ``SAT_SPEAKERS`` speakers of phase 8's utterances (76,800 frames) drawn
    from it on aligned pdfs and warped per speaker by a known affine
    transform.  Counted: the regression tree (``REGTREE_CLASSES`` base
    classes), per speaker ``acc_regtree_fmllr_stats``,
    ``estimate_regtree_fmllr`` and ``regtree_fmllr_loglikes`` (K2 a class),
    ``acc_regtree_mllr_stats`` over all frames (K6) and its estimate, the
    speakers' fMLLR statistics and a basis trained from them with one
    speaker's coefficients, and a ``FULL_UBM`` full-covariance GMM made by
    ``FullGmm.from_diag`` with ``loglikes_full`` and ``acc_full_stats`` over
    all frames.  Then each device function held to a float64 version and
    timed against its bound: the regression-tree fMLLR statistics of one
    speaker; ``regtree_fmllr_loglikes`` over all frames with one speaker's
    transforms, each class's K2 launch against K2's plain version in
    float64 and the whole against the JAX formulation in float64; the MLLR
    statistics; both full-covariance functions."""
    import numpy as np

    from voicebridge_tpu_torch.models.full_gmm import (FullGmm, acc_full_stats, loglikes_full,
                                                       pack_full_gmm)
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels
    from voicebridge_tpu_torch.testing import feature_scaled_am
    from voicebridge_tpu_torch.transforms import basis_fmllr as B
    from voicebridge_tpu_torch.transforms import fmllr as F
    from voicebridge_tpu_torch.transforms import regtree as R

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    if device.type == "cuda":
        torch.cuda.empty_cache()
    b, t, d = width.train_batch, width.train_frames, 40
    n, p, m = b * t, width.num_pdfs, width.max_mix
    rng = np.random.default_rng(19)
    am = feature_scaled_am(np.zeros(d), np.ones(d), p, m, seed=19)
    pdf = rng.integers(0, p, n).astype(np.int32)
    mix = rng.integers(0, m, n)
    clean = am.means()[pdf, mix] + rng.standard_normal((n, d)) * np.sqrt(
        am.variances()[pdf, mix])
    spk = np.repeat(np.arange(b) % SAT_SPEAKERS, t)
    eye = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    warp = eye + 0.05 * rng.standard_normal((SAT_SPEAKERS, d, d + 1))
    x_np = (np.einsum("nde,ne->nd", warp[spk, :, :d], clean) + warp[spk, :, d]).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    w = np.ones(n, np.float32)
    params = gmm_kernels.pack_gmm(am, device)
    rows = [np.flatnonzero(spk == s) for s in range(SAT_SPEAKERS)]
    facts: dict = {}
    reset_launches()
    t0 = time.perf_counter()
    tree = R.build_regression_tree(am.means(), am.weights, REGTREE_CLASSES)
    facts["tree_s"] = time.perf_counter() - t0
    per_spk, host_s = [], 0.0
    for s, r in enumerate(rows):
        stats = R.acc_regtree_fmllr_stats(params, am.means(), am.inv_vars, x[r], pdf[r], w[r],
                                          tree.bclass_of, tree.num_leaves, device=device)
        t1 = time.perf_counter()
        trans, l2c, imprs = R.estimate_regtree_fmllr(tree, *[a.cpu().numpy() for a in stats])
        host_s += time.perf_counter() - t1
        ll = R.regtree_fmllr_loglikes(params, x[r], trans, l2c, tree.bclass_of)
        check(np.isfinite(trans).all() and all(i >= 0 for i in imprs)
              and bool(torch.isfinite(ll[:, :p]).all()),
              f"phase 19: speaker {s}'s regression-tree fMLLR is not finite or worsens "
              f"({imprs})")
        per_spk.append((trans, l2c, imprs))
    occ, xbar = R.acc_regtree_mllr_stats(params, x, pdf, w)
    mllr, mllr_l2c = R.estimate_regtree_mllr(tree, occ, xbar, am.means(), am.inv_vars)
    check(np.isfinite(mllr).all(), "phase 19: an MLLR transform is not finite")
    beta, k, g = F.acc_fmllr_stats(params, am.means(), am.inv_vars, x, pdf, w, spk,
                                   SAT_SPEAKERS, device=device)
    t1 = time.perf_counter()
    basis = B.train_fmllr_basis(*[a.cpu().numpy() for a in (beta, k, g)])
    basis_s = time.perf_counter() - t1
    wb, impr_b, n_b = B.estimate_fmllr_basis(basis, float(beta[0]), k[0].cpu().numpy(),
                                             g[0].cpu().numpy())
    check(np.isfinite(wb).all() and impr_b >= 0, f"phase 19: basis fMLLR worsens ({impr_b})")
    ubm = FullGmm.from_diag(feature_scaled_am(np.zeros(d), np.ones(d), *FULL_UBM, seed=20))
    packed = pack_full_gmm(ubm, device)
    ll_full = loglikes_full(packed, x)
    zeros = np.zeros(n, np.int32)
    full_stats = acc_full_stats(packed, x, zeros, FULL_UBM[0])
    sync()
    facts.update(wall_s=time.perf_counter() - t0, launches=launch_counts(),
                 regtree_estimate_host_s=host_s, basis_train_host_s=basis_s,
                 classes=[len(tr) for tr, _, _ in per_spk],
                 imprs=[list(map(float, im)) for _, _, im in per_spk],
                 basis={"size": basis.size, "coefficients": n_b, "impr": impr_b},
                 mllr_classes=int(mllr.shape[0]))
    check(bool(torch.isfinite(ll_full).all()), "phase 19: full-covariance loglikes not finite")
    del ll_full, full_stats
    # ---- the card against float64 ----
    fns: dict = {}
    r0 = rows[0]
    x0, e = x[r0], d + 1
    got = R.acc_regtree_fmllr_stats(params, am.means(), am.inv_vars, x0, pdf[r0], w[r0],
                                    tree.bclass_of, tree.num_leaves, device=device)
    ref = regtree_stats_float64(torch, am, x0, pdf[r0], w[r0], tree.bclass_of,
                                tree.num_leaves)
    c, n0 = tree.num_leaves, len(r0)
    fns["acc_regtree_fmllr_stats"] = device_function(
        torch, "acc_regtree_fmllr_stats (one speaker)",
        [(got[0], ref[0], 1e-6, 0.0), (got[1], ref[1], 1e-4, 1e-4 * ref[3]),
         (got[2], ref[2], 1e-4, 1e-4 * ref[4])],
        lambda: R.acc_regtree_fmllr_stats(params, am.means(), am.inv_vars, x0, pdf[r0],
                                          w[r0], tree.bclass_of, tree.num_leaves,
                                          device=device),
        # rows, their pdfs' parameters and the statistics; per class the
        # collapsed statistics and the K and G products, the posteriors once
        (n0 * (4 * d + 8) + 4 * p * m * (2 * d + 1) + 4 * c * (1 + d * e + d * e * e),
         c * (2 * n0 * d * e * e + 2 * n0 * d * e + 4 * n0 * m * d) + 10 * n0 * m * d), log)
    del got, ref
    trans, l2c, _ = per_spk[0]
    cls = R.class_of_gaussians(tree.bclass_of, l2c)
    tr = torch.from_numpy(trans).to(device)
    k2_err = 0.0
    for q in range(len(trans)):  # each class's K2 launch against K2 in float64
        w_q, active = R.class_weights(params, cls, q)
        active = torch.from_numpy(active).to(device)
        x_q = torch.addmm(tr[q, :, -1], x, tr[q, :, :-1].T).contiguous()
        got_q, ref_q = gmm_kernel.loglikes(x_q, w_q)[:, active], k2_plain64(x_q, w_q)[:, active]
        k2_err = max(k2_err, float((got_q.double() - ref_q).abs().max()))
        check(bool(torch.allclose(got_q.double(), ref_q, rtol=TOL["gmm_loglikes"][0],
                                  atol=TOL["gmm_loglikes"][1])),
              f"phase 19: K2 on regression class {q} disagrees with its float64 plain "
              f"version ({k2_err})")
        del w_q, x_q, got_q, ref_q
    got = R.regtree_fmllr_loglikes(params, x, trans, l2c, tree.bclass_of)
    p64 = params.to(torch.float64)
    ref = torch.cat([R.regtree_fmllr_loglikes_plain(p64, x[lo:lo + 2048].double(), trans, l2c,
                                                    tree.bclass_of)
                     for lo in range(0, n, 2048)])
    kp = gmm_kernel.k_pad(params.w.shape[2])
    entry = device_function(
        torch, "regtree_fmllr_loglikes", [(got, ref, *TOL["gmm_loglikes"])],
        lambda: R.regtree_fmllr_loglikes(params, x, trans, l2c, tree.bclass_of),
        # per class K2's bytes and 3xTF32 products (the transforms' own
        # products, 2 n D E a class in float32, are a thousandth of these)
        (len(trans) * (nbytes(x, params.w) + 8 * n * p), len(trans) * 3 * 2 * n * p * m * kp), log,
        ops_per_s=TF32_OPS_PER_S)
    entry.update(classes=len(trans), k2_per_class_max_abs_err=k2_err)
    fns["regtree_fmllr_loglikes"] = entry
    del got, ref
    pdf_t = torch.from_numpy(pdf).to(device)
    ref = gmm_kernels.acc_gmm_stats_aligned(p64, x.double(), pdf_t, p,
                                            torch.ones(n, dtype=torch.float64, device=device))
    fns["acc_regtree_mllr_stats"] = device_function(
        torch, "acc_regtree_mllr_stats (K6)",
        [(torch.from_numpy(occ).to(device), ref[0], 1e-5, 1e-5 * float(ref[0].abs().max())),
         (torch.from_numpy(xbar).to(device), ref[1], 1e-5, 1e-5 * float(ref[1].abs().max()))],
        lambda: R.acc_regtree_mllr_stats(params, x, pdf, w),
        (nbytes(x) * 2 + 8 * n + 4 * p * m * (2 * d + 1) * 2, 8 * n * m * d), log)
    del ref
    f64 = {key: val.double() for key, val in packed.items()}
    pu, mu = FULL_UBM
    x64 = x.double()
    fns["loglikes_full"] = device_function(
        torch, "loglikes_full", [(loglikes_full(packed, x), loglikes_full(f64, x64),
                                  *TOL["gmm_loglikes"])],
        lambda: loglikes_full(packed, x),
        # frames in, loglikes out, the precisions; the quadratic form and
        # the linear term per (frame, Gaussian)
        (nbytes(x, packed["ic"], packed["ic_mu"]) + 4 * n * pu,
         n * pu * mu * (2 * d * d + 4 * d + 4)), log)
    got = acc_full_stats(packed, x, zeros, pu)
    ref = acc_full_stats(f64, x64, zeros, pu)
    # float32 sums over all frames: rtol 1e-5, atol 1e-5 of the largest entry
    fns["acc_full_stats"] = device_function(
        torch, "acc_full_stats",
        [(a, r, 1e-5, 1e-5 * float(r.abs().max())) for a, r in zip(got, ref)],
        lambda: acc_full_stats(packed, x, zeros, pu),
        (nbytes(x, packed["ic"], *got), n * mu * (4 * d * d + 6 * d + 8)), log)
    del got, ref, x64
    facts["device_functions"] = fns
    log(f"phase 19, adaptation at phase 16's shape on {device}: "
        f"{json.dumps({k: v for k, v in facts.items() if k != 'device_functions'})}")
    return facts


def silprob_full_width(torch, device, work: Path, ls: dict, log) -> dict:
    """Phase 19, silence probabilities: phase 18's project reopened, its
    training split aligned again with its tri1 model (the recipe keeps its
    alignments in memory; the same call, whose aligners are deterministic,
    gives them back), then ``get_prons``, ``estimate_silence_probs``,
    ``prepare_lang(silprobs=...)``, ``mkgraph`` and one lattice decode of the
    test split with the sweep (``Project.decode``), counted: its WER within
    2 points of phase 18's tri1 WER."""
    from voicebridge_tpu_torch.config import LangOptions
    from voicebridge_tpu_torch.data.dict import prepare_dict, read_ref_dict
    from voicebridge_tpu_torch.data.lang import prepare_lang, validate_lang
    from voicebridge_tpu_torch.fst.hclg import mkgraph
    from voicebridge_tpu_torch.fst.lexicon import silprobs_from_stats
    from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
    from voicebridge_tpu_torch.steps.get_prons import estimate_silence_probs, get_prons

    proj = reopen_librispeech(work, device)
    tri1, lang = proj.load_model("tri1"), proj.lang
    train = proj.train_data
    vocab = sorted({w for data in (train, proj.test_data) for u in data.utts
                    for w in data.text[u]})
    lexicon, _ = prepare_dict(vocab, read_ref_dict(work / "ref_dict.txt"), ["SIL"], "SIL",
                              proj.oov_word)
    reset_launches()
    t0 = time.perf_counter()
    ali = proj.align(tri1)
    pron_counts, sil_stats = get_prons(ali, {u: list(train.text[u]) for u in train.utts},
                                       tri1.trans_model, lang, lexicon)
    sp = estimate_silence_probs(sil_stats)
    lang2 = prepare_lang(lexicon, ["SIL"], "SIL", LangOptions(oov_word=proj.oov_word),
                         silprobs=silprobs_from_stats(sil_stats, sp["overall"]))
    hclg = mkgraph(lang2, tri1.tree, tri1.trans_model,
                   arpa_to_fst(proj.arpa, lang2.words.id, lang2.word_disambig_id))
    res = proj.decode(tri1, hclg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    facts = {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
             "wer": res.best_wer.wer, "tri1_wer": ls["wer"]["tri1"]["wer"],
             "overall_sil_prob": sp["overall"], "prons": sum(pron_counts.values()),
             "hclg_states": hclg.num_states}
    log(f"phase 19, silence probabilities on {device}: {json.dumps(facts)}")
    check(list(lang2.words.items()) == list(lang.words.items())
          and list(lang2.phones.items()) == list(lang.phones.items()) and not validate_lang(lang2),
          "phase 19: the silprob lang's tables differ from the project's, or it is not valid")
    check(pron_counts and 0.0 < sp["overall"] < 1.0,
          f"phase 19: no pronunciations counted or silence probability {sp['overall']}")
    check(facts["wer"] <= facts["tri1_wer"] + 2.0,
          f"phase 19: the silprob decode's WER {facts['wer']} is more than 2 points above "
          f"phase 18's tri1 WER {facts['tri1_wer']}")
    return facts


# ---------------------------------------------------------------------------
# Phase 20: the TF32 repair, multi-device statistics, the lane-major lattice FB
# ---------------------------------------------------------------------------

WS2_JOIN_S = 300.0  # the world-size-2 ranks' join limit
LANE_BEAM_RUN = (16, 13.0, 2000)  # the second lane-major run: lanes, beam, max_active
LANE_WINDOW = 64  # the lane-major FB's window (the JAX package's default)
LANE_PLAIN_LANES = 128  # lanes the plain version is held on (all of phase 9's)
FP64_OPS_PER_S = 67e12  # H100 SXM, float64 on the tensor cores, published
# MLLT's and fMLLR's float64 sums add fp32 posteriors (cuBLAS products): on
# the card MLLT's beta came out 1.5e-9 of its size apart between the sharded
# and the unsharded call on the same frames (the cause was not traced; world
# size 2 against 1 was equal).  LDA, tree and transition sums add exact
# terms and are held within 1e-9.
POSTERIOR_RTOL = 1e-7


def _precision(torch) -> str:
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        return m.fp32_precision
    return "tf32" if m.allow_tf32 else "ieee"


def tf32_guard(torch, device, lane: dict, final_mat, acc: dict, log) -> dict:
    """Phase 20, the TF32 repair: with ``"high"`` set by the caller, the
    deltas of phase 9's base features, their LDA decode features under phase
    15's matrix and ``acc_fmllr_stats`` at phase 16's shape equal, bit for
    bit, the same calls with TF32 off, and the caller's setting reads again
    after each call."""
    from voicebridge_tpu_torch.ops.features import add_deltas_batch
    from voicebridge_tpu_torch.ops.gmm_kernels import GmmParams
    from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats
    from voicebridge_tpu_torch.transforms.fmllr import acc_fmllr_stats

    base = lane["batch"][:, :, :13].contiguous()
    nf = torch.from_numpy(lane["nf"])
    by_utt = {f"u{i:04d}": base[i, : int(n)] for i, n in enumerate(lane["nf"])}
    g = acc["gmm40"]
    params = GmmParams(torch.from_numpy(g["w"]).to(device), g["live"])
    calls = {
        "add_deltas_batch": lambda: add_deltas_batch(base, nf),
        "lda_decode_feats": lambda: torch.cat(list(lda_decode_feats(by_utt, final_mat,
                                                                    device=device).values())),
        "acc_fmllr_stats": lambda: torch.cat([t.reshape(-1) for t in acc_fmllr_stats(
            params, g["means"], g["inv_vars"], acc["x40"], acc["pdf40"], acc["w40"],
            acc["spk40"], SAT_SPEAKERS, device=device)])}
    facts = {}
    for name, call in calls.items():
        torch.set_float32_matmul_precision("high")
        try:
            check(_precision(torch) == "tf32", f"phase 20: 'high' reads {_precision(torch)}")
            under = call()
            check(_precision(torch) == "tf32",
                  f"phase 20: {name} left the caller's precision at {_precision(torch)}")
        finally:
            torch.set_float32_matmul_precision("highest")
        off = call()
        same = bool(torch.equal(under, off))
        facts[name] = {"bit_equal": same, "elements": under.numel(),
                       "max_abs_diff": float((under.double() - off.double()).abs().max())}
        check(same, f"phase 20: {name} under the caller's TF32 differs from TF32 off: "
                    f"{facts[name]}")
    log(f"phase 20, TF32 guard on {device}: {json.dumps(facts)}")
    return facts


def phase20_arrays(torch, device, width: Width) -> dict:
    """The numpy inputs of phase 20's sharded programs, from seeds: phase
    8's training shape with its K4 alignment (the E-steps' given alignment),
    phase 12's generic graphs, and at phase 15 and 16's shapes spliced
    features for LDA and 40-dim features of ``SAT_SPEAKERS`` speakers under
    a 2000 x 5 x 40 GMM for MLLT and fMLLR; the tree statistics' events are
    phase 8's aligned pdfs."""
    import numpy as np

    from voicebridge_tpu_torch.ops import gmm_kernels as K
    from voicebridge_tpu_torch.ops import viterbi as V
    from voicebridge_tpu_torch.testing import random_am

    graphs, aset, feats, nf = train_shape(width, device)
    am = random_am(width.num_pdfs, width.max_mix, 39, seed=4)
    params = K.pack_gmm(am, device)
    alis = aset.align_feats(params, feats, nf, acoustic_scale=0.1)
    check(all(len(r["arcs"]) == n for r, n in zip(alis, nf)), "phase 20: an utterance did not align")
    pdf = np.stack([g.arc_pdf[r["arcs"]] for g, r in zip(graphs, alis)]).astype(np.int32)
    band = aset.band
    gen_graphs, _aset, _f, _n = train_shape(width, "cpu", width.back_arcs)
    padded = V.pad_graphs(gen_graphs)
    b, t, _d = feats.shape
    n = b * t
    rng = np.random.default_rng(20)
    am40 = random_am(width.num_pdfs, width.max_mix, 40, seed=9)
    p40 = K.pack_gmm(am40, "cpu")
    w_lda = np.ones(n, np.float32)
    w_lda[::7] = 0.25
    out = dict(
        feats=feats.cpu().numpy(), nf=nf, tids=pdf, pdf_ids=pdf,
        weights=np.ones((b, t), np.float32), gmm=dict(w=params.w.cpu().numpy(),
                                                      live=params.live),
        band_W=band.W, band_pdf=band.pdf, band_alpha0=band.alpha0,
        band_offsets=np.asarray(band.offsets, np.int32),
        gen={k: padded[k] for k in ("arc_src", "arc_dst", "arc_pdf", "arc_score", "alpha0")},
        gen_states=padded["num_states"],
        lda_x=rng.standard_normal((n, 13 * 7), dtype=np.float32),
        lda_pdf=rng.integers(0, width.num_pdfs, n).astype(np.int32), lda_w=w_lda,
        x40=rng.standard_normal((n, 40), dtype=np.float32),
        pdf40=rng.integers(0, width.num_pdfs, n).astype(np.int32),
        w40=np.ones(n, np.float32),
        spk40=np.repeat(np.arange(b, dtype=np.int32) % SAT_SPEAKERS, t),
        gmm40=dict(w=p40.w.numpy(), live=p40.live,
                   means=am40.means().astype(np.float32),
                   inv_vars=am40.inv_vars.astype(np.float32)))
    return out


def sharded_programs(torch, mesh, a: dict, width: Width, timed: bool) -> dict:
    """The sharded E-step (banded) and the four accumulators over ``mesh``
    on the arrays of ``phase20_arrays``; each result as host tensors, with
    its wall time (synchronized) when ``timed``."""
    from voicebridge_tpu_torch.ops.gmm_kernels import GmmParams
    from voicebridge_tpu_torch.parallel import mesh as M
    from voicebridge_tpu_torch.transforms.fmllr import acc_fmllr_stats

    dev = mesh.device
    params = GmmParams(torch.from_numpy(a["gmm"]["w"]).to(dev), a["gmm"]["live"])
    g40 = a["gmm40"]
    p40 = GmmParams(torch.from_numpy(g40["w"]).to(dev), g40["live"])
    feats = torch.from_numpy(a["feats"]).to(dev)
    data = (feats, a["nf"], a["tids"], a["pdf_ids"], a["weights"])
    b, t, d = a["feats"].shape
    num_tids = width.num_pdfs - 1  # IdentityTransitions: a tid is its pdf
    calls = {
        "em_estep_sharded_banded": lambda: M.em_estep_sharded_banded(
            mesh, width.num_pdfs, num_tids, a["band_offsets"])(
            params, a["band_W"], a["band_pdf"], a["band_alpha0"], *data, 0.1),
        "acc_lda_stats_sharded": lambda: M.acc_lda_stats_sharded(mesh, width.num_pdfs)(
            a["lda_x"], a["lda_pdf"], a["lda_w"]),
        "acc_mllt_stats_sharded": lambda: M.acc_mllt_stats_sharded(mesh)(
            p40, g40["means"], g40["inv_vars"], a["x40"], a["pdf40"], a["w40"]),
        "acc_fmllr_stats_sharded": lambda: acc_fmllr_stats(
            p40, g40["means"], g40["inv_vars"], a["x40"], a["pdf40"], a["w40"], a["spk40"],
            SAT_SPEAKERS, mesh=mesh),
        "acc_tree_stats_sharded": lambda: M.acc_tree_stats_sharded(mesh, width.num_pdfs)(
            feats.reshape(b * t, d), a["pdf_ids"].reshape(-1), a["weights"].reshape(-1)),
    }
    out = {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        res = call()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if timed:  # again, now that everything is built and warm
            t0 = time.perf_counter()
            res = call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        out[name] = {"result": [x.cpu() for x in res], "wall_ms": 1e3 * wall}
    return out


def _ws2_rank(rank: int, world: int, store: str, arrays: str, out: str, device: str) -> None:
    """One rank of phase 20's world size 2 (``gloo``, both ranks on
    ``cuda:0``): the sharded programs on the saved arrays; writes its
    results or its error to ``out/rank<rank>.pt``."""
    import pickle
    import traceback

    import torch
    import torch.distributed as dist

    sys.path[:0] = [str(ROOT)]
    res: dict
    try:
        from voicebridge_tpu_torch.parallel import mesh as M

        with open(arrays, "rb") as f:
            a, width = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        mesh = M.make_mesh(devices=device)
        res = {k: v["result"] for k, v in sharded_programs(torch, mesh, a, width,
                                                            False).items()}
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported by the parent
        res = {"error": traceback.format_exc()}
    torch.save(res, f"{out}/rank{rank}.pt")


def world_size_two(torch, device, arrays: dict, width: Width, log) -> list:
    """Start phase 20's two ``gloo`` ranks with ``spawn`` (on the card: both
    on ``cuda:0``; NCCL refuses two ranks on one device), wait at most
    ``WS2_JOIN_S``, kill what is left and fail; returns each rank's
    results."""
    import multiprocessing as mp
    import pickle

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ws2_") as tmp:
        path = f"{tmp}/arrays.pkl"
        with open(path, "wb") as f:
            pickle.dump((arrays, width), f)
        ctx = mp.get_context("spawn")
        dev = "cuda:0" if device.type == "cuda" else "cpu"
        procs = [ctx.Process(target=_ws2_rank, args=(r, 2, f"{tmp}/store", path, tmp, dev),
                             daemon=True) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + WS2_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        check(not hung, f"phase 20: {len(hung)} world-size-2 rank(s) did not finish in "
                        f"{WS2_JOIN_S} s")
        res = []
        for r in range(2):
            got = torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            check("error" not in got, f"phase 20: world-size-2 rank {r}: {got.get('error')}")
            res.append(got)
    log(f"phase 20: world size 2 over gloo on {device} in {time.perf_counter() - t0:.1f} s")
    return res


def _close(torch, got, ref, rtol: float, what: str, atol: float = 0.0) -> float:
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    check(got.shape == ref.shape and bool(torch.allclose(got, ref, rtol=rtol, atol=atol)),
          f"phase 20: {what} differs (max abs {err}, rtol {rtol})")
    return err


def sharded_bounds(a: dict, width: Width) -> dict:
    """Each sharded program's least time, the larger of its bytes (inputs
    once, outputs once) over the memory rate and its operations over the
    rate of their type: the E-step's K2 products (3xTF32), K4's relaxations
    and K6's sums (float32); LDA's second moment and fMLLR's block products
    (float64); MLLT's block products (float32); the tree sums (float64)."""
    b, t, d = a["feats"].shape
    n, p, m = b * t, width.num_pdfs, width.max_mix
    s, k = a["band_W"].shape[1:]
    e = 40
    stats_bytes = 8 * p * m * (2 * d + 1)
    estep = (4 * n * d + 4 * b * s * k * 2 + 12 * n + n * s + 4 * b * s + stats_bytes,
             3 * 2 * n * (2 * d + 1) * p * m / TF32_OPS_PER_S + (4 * n * s * k + 6 * n * m * d)
             / FP32_OPS_PER_S)
    sd = a["lda_x"].shape[1]
    lda = (4 * n * (sd + 2) + 8 * p * (sd + 1) + 8 * sd * sd, 2 * n * sd * sd / FP64_OPS_PER_S)
    mllt = (4 * n * (e + 2) + 8 * p * m * (2 * e + 1) + 8 * e ** 3,
            2 * n * m * e ** 3 / FP32_OPS_PER_S)
    fmllr = (4 * n * (e + 3) + 8 * p * m * (2 * e + 1) + 8 * SAT_SPEAKERS * e * (e + 1) ** 2,
             2 * n * e * (e + 1) ** 2 / FP64_OPS_PER_S)
    tree = (4 * n * (d + 2) + 8 * p * (2 * d + 1), 3 * n * d / FP64_OPS_PER_S)
    arcs = a["gen"]["arc_src"].size  # the generic E-step: K2, the forward over every arc, K6
    s_gen = a["gen"]["alpha0"].shape[1]
    generic = (4 * n * d + 16 * arcs + 4 * b * s_gen + 4 * t * b * s_gen + 12 * n + stats_bytes,
               estep[1] - 4 * n * s * k / FP32_OPS_PER_S + 4 * t * arcs / FP32_OPS_PER_S)
    out = {}
    for name, (byts, op_s) in (("em_estep_sharded_banded", estep), ("em_estep_sharded", generic),
                               ("acc_lda_stats_sharded", lda),
                               ("acc_mllt_stats_sharded", mllt),
                               ("acc_fmllr_stats_sharded", fmllr),
                               ("acc_tree_stats_sharded", tree)):
        byte_ms, op_ms = 1e3 * byts / HBM_BYTES_PER_S, 1e3 * op_s
        out[name] = {"bound_ms": max(byte_ms, op_ms),
                     "bound_by": "bytes" if byte_ms >= op_ms else "operations"}
    return out


def parallel_full_width(torch, device, width: Width, a: dict, lane: dict, log) -> dict:
    """Phase 20, multi-device statistics: world size 1 in this process (NCCL
    on a card, gloo on the CPU; a file store, the group destroyed after) at
    phase 8, 12, 15 and 16's shapes and phase 7's decode shape, each program
    held to the port's unsharded functions and timed with its all-reduce
    beside it; then world size 2 over gloo, held to world size 1."""
    import numpy as np
    import torch.distributed as dist

    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import gmm_kernel
    from voicebridge_tpu_torch.ops import gmm_kernels as K
    from voicebridge_tpu_torch.ops import viterbi as V
    from voicebridge_tpu_torch.ops.gmm_kernels import GmmParams
    from voicebridge_tpu_torch.parallel import mesh as M
    from voicebridge_tpu_torch.transforms.fmllr import fmllr_sums
    from voicebridge_tpu_torch.transforms.lda import lda_sums
    from voicebridge_tpu_torch.transforms.mllt import acc_mllt_stats

    t_start = time.perf_counter()
    cuda = device.type == "cuda"
    facts: dict = {"programs": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ws1_") as tmp:
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = M.make_mesh(devices=device)
            reset_launches()
            one = sharded_programs(torch, mesh, a, width, cuda)
            from voicebridge_tpu_torch import _build
            launches = dict(_build.launches)
            # the generic E-step over phase 12's graphs, and the decode forward
            gen = a["gen"]
            params = GmmParams(torch.from_numpy(a["gmm"]["w"]).to(device), a["gmm"]["live"])
            feats = torch.from_numpy(a["feats"]).to(device)
            data = (feats, a["nf"], a["tids"], a["pdf_ids"], a["weights"])
            t0 = time.perf_counter()
            g_res = M.em_estep_sharded(mesh, a["gen_states"], width.num_pdfs, width.num_pdfs - 1)(
                params, gen["arc_src"], gen["arc_dst"], gen["arc_pdf"], gen["arc_score"],
                gen["alpha0"], *data, 0.1)
            if cuda:
                torch.cuda.synchronize()
            one["em_estep_sharded"] = {"result": [x.cpu() for x in g_res],
                                       "wall_ms": 1e3 * (time.perf_counter() - t0)}
            dec = lane["dec"]
            ll = dec._loglikes(lane["batch"].contiguous())
            s1 = dec.plan.row_start.shape[0] - 1
            alpha = torch.full((s1, width.batch), DC.NEG_INF, device=device)
            alpha[torch.from_numpy(dec.plan.sperm[np.flatnonzero(
                dec.graph.alpha0 > DC.NEG_INF / 2)]).long().to(device)] = 0.0
            alpha_end = torch.full_like(alpha, DC.NEG_INF)
            acwt = float(np.float32(1.0 / 13.0))
            step = M.decode_forward_sharded(mesh, dec.plan.packed, dec.plan.rspec)
            t0 = time.perf_counter()
            d_res = step(dec.plan_dev, alpha, alpha_end, ll, lane["nf"], acwt)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r, d_w = dec.plan_dev.row_w.shape
            byts = (nbytes(ll) + d_res[2].numel() * d_res[2].element_size()
                    + k3_plan_bytes(dec.plan_dev) + 3 * nbytes(alpha))
            byte_ms = 1e3 * byts / HBM_BYTES_PER_S
            op_ms = 1e3 * 3 * width.batch * r * d_w * ll.shape[1] / FP32_OPS_PER_S
            one["decode_forward_sharded"] = {
                "wall_ms": 1e3 * wall, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations"}
            (ra, rae), rbps = DC.viterbi_scan(dec.plan_dev, alpha.clone(), alpha_end.clone(),
                                              ll.permute(1, 2, 0).contiguous(),
                                              torch.from_numpy(lane["nf"]).to(device), 0, acwt,
                                              dec.plan.rspec, dec.plan.packed)
            for got, ref, what in zip(d_res, (ra, rae, rbps),
                                      ("K3's alpha", "K3's alpha_end", "K3's codes")):
                check(bool(torch.equal(got, ref)),
                      f"phase 20: decode_forward_sharded's {what} differ from viterbi_scan's")
            del d_res, rbps, ra, rae, ll
            # the all-reduce alone, on float64 tensors of each program's statistics
            for name, entry in one.items():
                stats = [x.to(device).double() for x in entry.get("result", [])[2:]
                         if x.dtype.is_floating_point] if name.startswith("em_") else \
                    [x.to(device).double() for x in entry.get("result", [])]
                if stats:
                    entry["all_reduce_ms"] = (cuda_ms(torch, lambda: M.all_reduce_stats(
                        mesh, stats), reps=3) if cuda else None)
                    entry["all_reduce_bytes"] = 8 * sum(x.numel() for x in stats)
        finally:
            dist.destroy_process_group()
    # ---- held to the port's unsharded functions ----
    b, t, d = a["feats"].shape
    n = b * t
    ll = gmm_kernel.loglikes_batch(feats, params)
    nf_t = torch.from_numpy(a["nf"]).to(device)
    ae, bps = AB.viterbi_forward_banded(
        torch.from_numpy(a["band_W"]).to(device), torch.from_numpy(a["band_pdf"]).to(device),
        torch.from_numpy(a["band_alpha0"]).to(device), ll, nf_t, 0.1,
        torch.from_numpy(a["band_offsets"]).to(device))
    x = feats.reshape(n, d)
    wt = torch.ones(n, device=device)
    sums = K.acc_gmm_stats_sums(params, x, x, a["pdf_ids"].reshape(-1), width.num_pdfs, wt)
    tst = K.transition_sums(torch.from_numpy(a["tids"].reshape(-1)).to(device),
                            width.num_pdfs - 1, wt)
    errs = {}
    res = one["em_estep_sharded_banded"]["result"]
    check(bool(torch.equal(res[0], ae.cpu())) and bool(torch.equal(res[1], bps.cpu())),
          "phase 20: the sharded banded E-step's alignment differs from K4's")
    errs["em_estep_sharded_banded"] = max(
        [_close(torch, g, r.cpu(), 1e-5, f"K6 sums ({i})", 1e-6 * float(r.abs().max()))
         for i, (g, r) in enumerate(zip(res[2:5], sums[:3]))]
        + [_close(torch, res[5], tst.cpu(), 1e-9, "transition sums"),
           _close(torch, res[6], sums[3].cpu(), 1e-5, "the E-step ll")])
    gen = a["gen"]
    ae_g, bps_g = V.viterbi_forward_batched(gen["arc_src"], gen["arc_dst"], gen["arc_pdf"],
                                            gen["arc_score"], gen["alpha0"], ll, a["nf"], 0.1,
                                            1e9, a["gen_states"])
    res_g = one["em_estep_sharded"]["result"]
    check(bool(torch.equal(res_g[0], ae_g.cpu())) and bool(torch.equal(res_g[1], bps_g.cpu())),
          "phase 20: the sharded generic E-step's alignment differs from the generic aligner's")
    errs["em_estep_sharded"] = max(_close(torch, g, r, 1e-9, "generic E-step statistics")
                                   for g, r in zip(res_g[2:], res[2:]))
    del ll, bps, bps_g
    g40 = a["gmm40"]
    p40 = GmmParams(torch.from_numpy(g40["w"]).to(device), g40["live"])
    lda = lda_sums(torch.from_numpy(a["lda_x"]).to(device), a["lda_pdf"], a["lda_w"],
                   width.num_pdfs)
    errs["acc_lda_stats_sharded"] = max(
        _close(torch, g, r.cpu(), 1e-9, "LDA statistics")
        for g, r in zip(one["acc_lda_stats_sharded"]["result"], lda))
    # one chunk, the frames world size 1 gives its one rank
    mllt = acc_mllt_stats(p40, g40["means"], g40["inv_vars"], a["x40"], a["pdf40"], a["w40"],
                          chunk=n)
    got = one["acc_mllt_stats_sharded"]["result"]
    errs["acc_mllt_stats_sharded"] = max(
        _close(torch, got[0].float(), mllt[0].cpu(), POSTERIOR_RTOL, "MLLT G",
               POSTERIOR_RTOL * float(mllt[0].abs().max())),
        _close(torch, got[1], mllt[1], POSTERIOR_RTOL, "MLLT beta"))
    fm = fmllr_sums(p40, g40["means"], g40["inv_vars"], a["x40"], a["pdf40"], a["w40"],
                    a["spk40"], SAT_SPEAKERS)
    errs["acc_fmllr_stats_sharded"] = max(
        _close(torch, g, r.float().cpu(), POSTERIOR_RTOL, "fMLLR statistics",
               POSTERIOR_RTOL * float(r.abs().max()))
        for g, r in zip(one["acc_fmllr_stats_sharded"]["result"], fm))
    ids = a["pdf_ids"].reshape(-1)
    xf = a["feats"].reshape(n, d)
    ref_tree = [np.zeros(width.num_pdfs), np.zeros((width.num_pdfs, d)),
                np.zeros((width.num_pdfs, d))]
    np.add.at(ref_tree[0], ids, 1.0)
    np.add.at(ref_tree[1], ids, xf)
    np.add.at(ref_tree[2], ids, xf * xf)
    errs["acc_tree_stats_sharded"] = max(
        _close(torch, g, torch.from_numpy(r), 1e-9, "tree statistics")
        for g, r in zip(one["acc_tree_stats_sharded"]["result"], ref_tree))
    # ---- world size 2 over gloo, held to world size 1 ----
    two = world_size_two(torch, device, a, width, log)
    ws2 = {}
    for name, entry in one.items():
        if name not in two[0]:
            continue
        ref = entry["result"]
        for rank, res in enumerate(two):
            check(all(bool(torch.equal(x, y)) for x, y in zip(res[name][2:] if name.startswith(
                "em_") else res[name], two[0][name][2:] if name.startswith("em_")
                else two[0][name])), f"phase 20: the two ranks' {name} differ")
        got = two[0][name]
        if name.startswith("em_"):
            half = ref[0].shape[0] // 2
            for rank, res in enumerate(two):
                check(bool(torch.equal(res[name][0], ref[0][rank * half:(rank + 1) * half])),
                      f"phase 20: rank {rank}'s alpha_end block differs from world size 1's rows")
            ws2[name] = max([_close(torch, g, r, 1e-5, f"{name} K6 sums at world size 2",
                                    1e-6 * float(r.abs().max()))
                             for g, r in zip(got[2:5], ref[2:5])]
                            + [_close(torch, got[5], ref[5], 1e-9, "transition sums, ws 2")])
        else:
            rtol = POSTERIOR_RTOL if name in ("acc_mllt_stats_sharded",
                                              "acc_fmllr_stats_sharded") else 1e-9
            ws2[name] = max(_close(torch, g, r, rtol, f"{name} at world size 2",
                                   rtol * float(r.abs().max()) if rtol > 1e-9 else 0.0)
                            for g, r in zip(got, ref))
    bounds = sharded_bounds(a, width)
    for name, entry in one.items():
        entry.pop("result", None)
        entry.update(bounds.get(name, {}))
        entry["max_abs_err_vs_unsharded"] = errs.get(name)
        entry["max_abs_err_ws2_vs_ws1"] = ws2.get(name)
        facts["programs"][name] = entry
    facts["launches"] = launches
    facts["wall_s"] = time.perf_counter() - t_start
    log(f"phase 20, multi-device statistics on {device}: {json.dumps(facts)}")
    return facts


def bytes_differ(a, b, frames: int = 16) -> int:
    """Entries where two equal-shaped ``[T, ...]`` tensors differ, counted
    ``frames`` frames at a time (a whole-tensor sum of the comparison would
    widen it to int64 at once)."""
    return sum(int((a[lo:lo + frames] != b[lo:lo + frames]).sum())
               for lo in range(0, a.shape[0], frames))


def lane_fb_full_width(torch, device, width: Width, lane: dict, results: dict, log) -> dict:
    """Phase 20, the lane-major lattice FB at phase 9's shape (its graph, GMM
    and features; acoustic scale 1/13, lattice beam 6) through
    ``lattice_forward_backward_packed``: at exact search the kernel's packed
    survivor bytes equal the plain version's on the card, and total_best
    equals decode_batch's exact best-path scores; a second run of
    ``LANE_BEAM_RUN`` lanes at a finite beam and max_active, byte for byte;
    times at exact search and, on all lanes, at that beam and max_active;
    the device kernels of one call counted under torch.profiler.
    The reference's survivor test drops whole frames at large totals, so
    the full-width check is kernel against plain version, not the beam
    invariant."""
    import numpy as np

    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import lattice as LAT

    dec = lane["dec"]
    g = dec.graph
    plan = LAT.lane_plan_to_device(g, LAT.build_dst_plan(g), LAT.build_src_plan(g), device)
    ll = dec._loglikes(lane["batch"].contiguous())
    nf = lane["nf"]
    acwt, lbeam = 1.0 / 13.0, 6.0
    cuda = device.type == "cuda"

    def kernel(lanes=None, beam=1e9, max_active=0):
        x = ll if lanes is None else ll[:lanes].contiguous()
        k = nf if lanes is None else nf[:lanes]
        return LAT.lattice_forward_backward_packed(plan, x, k, acwt, beam, lbeam, max_active,
                                                   LANE_WINDOW)

    def plain(lanes=None, beam=1e9, max_active=0):
        """The plain version on the same device and inputs."""
        x = ll if lanes is None else ll[:lanes].contiguous()
        k = nf if lanes is None else nf[:lanes]
        return LAT.lattice_forward_backward_packed(
            plan, x, k, acwt, beam, lbeam, max_active, LANE_WINDOW,
            steps=(LAT.lane_forward_plain, LAT.lane_backward_plain))

    reset_launches()
    t0 = time.perf_counter()
    bits, best, at_end, use_final = kernel()
    if cuda:
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    windows = -(-int(ll.shape[1]) // LANE_WINDOW)  # phase 1 forward, phase 2 forward + backward
    check(not cuda or launches["lattice_lane"] == 3 * windows,
          f"phase 20: the lane-major FB launched {launches['lattice_lane']} times for "
          f"{windows} windows")
    exact = lane["exact"]
    got = best.double().cpu().numpy()
    worst = float(np.max(np.abs(got - exact) / np.maximum(np.abs(exact), 1.0)))
    check(bool(use_final.all()) and all(abs(x - e) <= max(1e-2, 1e-5 * abs(e))
                                        for x, e in zip(got, exact)),
          f"phase 20: lane-major total_best against decode_batch's best paths: rel err {worst}")
    t0 = time.perf_counter()
    pb, pbest, pend, puse = plain(LANE_PLAIN_LANES)
    if cuda:
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    lanes = pb.shape[1]
    diff = bytes_differ(bits[:, :lanes], pb)
    check(diff == 0 and bool(torch.equal(best[:lanes], pbest)) and bool(torch.equal(
        at_end[:lanes], pend)) and bool(torch.equal(use_final[:lanes], puse)),
          f"phase 20: the lane-major kernel's packed survivors differ from the plain "
          f"version's in {diff} bytes")
    ones = torch.tensor([bin(i).count("1") for i in range(256)], device=device)
    survivors = sum(int(ones[bits[lo:lo + 16].long()].sum()) for lo in range(0, bits.shape[0], 16))
    ms_cut = cuda_ms(torch, lambda: kernel(lanes), reps=2) if cuda and lanes < ll.shape[0] \
        else None
    del pb, pend
    n2, beam2, ma2 = LANE_BEAM_RUN
    kb = kernel(n2, beam2, ma2)
    pbb = plain(n2, beam2, ma2)
    diff2 = bytes_differ(kb[0], pbb[0])
    check(diff2 == 0 and bool(torch.equal(kb[1], pbb[1])),
          f"phase 20: at beam {beam2}, max_active {ma2} the lane-major kernel differs from its "
          f"plain version in {diff2} bytes")
    del kb, pbb
    ms = cuda_ms(torch, kernel, reps=2) if cuda else None
    ms_beam = cuda_ms(torch, lambda: kernel(None, beam2, ma2), reps=2) if cuda else None
    # one device kernel per window and pass, where the profiler sees the card
    prof = device_profile(torch, kernel, calls=1) if cuda else {"activities_by_name": {}}
    lane_kernels = sum(v for k, v in prof["activities_by_name"].items()
                       if "lane_forward_kernel" in k or "lane_backward_kernel" in k)
    check(not prof["activities_by_name"] or round(lane_kernels) == 3 * windows,
          f"phase 20: {lane_kernels} lane-major device kernels for {windows} windows")
    # the bound (tools/lane_major_fb_bound.py's count at this run's sizes):
    # bytes of the inputs once and the outputs once; operations per (lane,
    # arc, frame) 4 forward and 6 backward, per (lane, state, frame) 4
    b, t, p = ll.shape
    s, a = g.num_states, g.num_arcs
    byts = 4 * b * t * p + 16 * a + 4 * s + 8 * (s + 1) + 8 * a + t * b * ((a + 7) // 8) \
        + 4 * b * s + 5 * b
    ops = 10 * b * a * t + 4 * b * s * t
    byte_ms, op_ms = 1e3 * byts / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    results["lattice_lane"] = {
        "max_abs_err": float((best[:lanes] - pbest).abs().max()), "ms": ms,
        "plain_ms": 1e3 * plain_s if cuda else None, "ms_at_plain_lanes": ms_cut,
        "bound_ms": max(byte_ms, op_ms), "bound_by": "bytes" if byte_ms >= op_ms else "operations",
        "library_ms": None, "plain_lanes": lanes, "packed_bytes": bits.numel(),
        "ms_beam_max_active": ms_beam}
    facts = {"launches": launches, "first_run_s": first_s, "plain_s": plain_s,
             "plain_lanes": lanes, "total_best_rel_err_max": worst, "survivors": survivors,
             "packed_bytes": bits.numel(), "beam_run": {"lanes": n2, "beam": beam2,
                                                       "max_active": ma2, "bytes_differ": diff2},
             "bound_ms": results["lattice_lane"]["bound_ms"], "ms": ms,
             "ms_beam_max_active": ms_beam, "device_kernels": lane_kernels,
             "device_activities": prof.get("activities_per_call"),
             "device_ms": prof.get("device_ms")}
    log(f"phase 20, lane-major lattice FB on {device}: {json.dumps(facts)}")
    return facts


def run(device, width: Width, log=print) -> dict:
    """Phases 2-20 on ``device``; returns the kernels report.  On a CPU
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
    kernels: dict = {}
    record = make_record(torch, kernels, log, device.type == "cuda")
    compare_kernels(torch, device, width, kernels, record, log)
    reset_launches()
    kernels["gmm_loglikes"]["max_abs_err_yesno"] = decode_yesno(torch, device, log)
    launched(_build.launches, DECODE_KERNELS, "yes-no decode")
    reset_launches()
    lattice_yesno(torch, device, log)
    launched(_build.launches, LATTICE_KERNELS, "yes-no lattice decode")
    launched(train_yesno(torch, device, log), TRAIN_KERNELS, "yes-no training")
    decode = decode_full_width(torch, device, width, log)
    launched(decode["launches"], DECODE_KERNELS, "the full-width decode")
    if device.type == "cuda":  # keep mode: one K3 window and one backtrace per sub-batch
        check(decode["launches"]["backtrace_best"] == decode["launches"]["viterbi_step"],
              f"the full-width decode launched backtrace_best "
              f"{decode['launches']['backtrace_best']} times for "
              f"{decode['launches']['viterbi_step']} K3 blocks")
    train = train_full_width(torch, device, width, log)
    launched(train["launches"], TRAIN_KERNELS, "the full-width EM iteration")
    lattice = lattice_full_width(torch, device, width, log)
    lane = lattice.pop("lane")
    launched(lattice["launches"], LATTICE_KERNELS, "the full-width lattice decode")
    kernels["gmm_loglikes"]["max_abs_err_lattice_features"] = lattice["k2_max_abs_err"]
    reset_launches()
    nbest_yesno(torch, device, log)
    launched(_build.launches, NBEST_KERNELS, "yes-no N-best decode")
    nbest = nbest_full_width(torch, device, width, log)
    launched(nbest["launches"], NBEST_KERNELS, "the full-width N-best decode")
    compare_backtrace_nbest(torch, *nbest.pop("walk"), width, record, log)
    generic = generic_full_width(torch, device, width, log)
    launched(generic["launches"], GENERIC_KERNELS, "the full-width generic alignment")
    rates = features_other_rates(torch, device, width, log)
    for sr, facts in rates.items():
        launched(facts["launches"], ("mfcc_frames",), f"make_features at {sr} Hz")
    tri = tri_yesno(torch, device, log)
    launched(tri["fixture"]["launches"], DECODE_KERNELS, "the tri2b fixture decode")
    for part in ("tri1", "tri2b"):
        launched(tri[part]["launches"],
                 ("gmm_loglikes", "gmm_stats", *aligner_kernels(tri[part]["aligner"])),
                 f"{part} training")
    lda = lda_mllt_full_width(torch, device, width, record, kernels, log)
    launched(lda["train"]["launches"], TRAIN_KERNELS, "the full-width tri2b EM iteration")
    launched(lda["decode"]["launches"], DECODE_KERNELS, "the full-width LDA decode")
    if device.type == "cuda":  # keep mode, as phase 7
        check(lda["decode"]["launches"]["backtrace_best"]
              == lda["decode"]["launches"]["viterbi_step"],
              f"the full-width LDA decode launched backtrace_best "
              f"{lda['decode']['launches']['backtrace_best']} times for "
              f"{lda['decode']['launches']['viterbi_step']} K3 blocks")
    for part in ("delta_sat", "lda_sat"):
        launched(tri[part]["launches"],
                 ("gmm_loglikes", "gmm_stats", *aligner_kernels(tri[part]["aligner"])),
                 f"{part} training")
    launched(tri["sat_fixture"]["launches"], LATTICE_KERNELS[1:],  # features made before
             "the SAT fixture's fMLLR decode")
    final_mat = lda.pop("final_mat")
    sat = sat_full_width(torch, device, width, record, kernels, final_mat, log)
    launched(sat["train"]["launches"], TRAIN_KERNELS, "the full-width SAT EM iteration")
    launched(sat["train"]["alimdl_launches"], ("gmm_stats",), "the full-width alimdl")
    launched(sat["decode"]["launches"], LATTICE_KERNELS, "the full-width fMLLR decode")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_project_") as work:
        examples = project_examples(torch, device, Path(work), log)
    for name in ("yesno", "full_pipeline"):
        launched(examples[name]["launches"], PROJECT_KERNELS, f"the {name} example")
        check(device.type != "cuda" or aligner_of(examples[name]["launches"]) != "none launched",
              f"the {name} example launched no aligner")
    launched(examples["yesno_reopened"]["launches"], LATTICE_KERNELS[1:],  # features loaded
             "the reopened Yes-No project's decode")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_librispeech_") as work:
        ls = project_librispeech(torch, device, Path(work), log)
        t19 = time.perf_counter()
        silprob = silprob_full_width(torch, device, Path(work), ls, log)
    ls_all = {k: sum(n.get(k, 0) for n in ls["launches"].values()) for k in _build.launches}
    launched(ls_all, PROJECT_KERNELS, "phase 18's Project sequence")
    launched(silprob["launches"], LATTICE_KERNELS[1:], "phase 19's silprob decode")
    fronts = frontends_full_width(torch, device, width, record, kernels, log)
    launched(fronts["launches"], ("mfcc_frames", "mfcc_mel_power"), "phase 19's extractors")
    launched(fronts["pitch"]["launches"], ("mfcc_frames",), "phase 19's make_features(pitch)")
    adapt = adaptation_full_width(torch, device, width, log)
    launched(adapt["launches"], ("gmm_loglikes", "gmm_stats"), "phase 19's adaptation")
    phase19_s = time.perf_counter() - t19
    log(f"phase 19 on {device}: {phase19_s:.1f} s")
    t20 = time.perf_counter()
    arrays = phase20_arrays(torch, device, width)
    tf32 = tf32_guard(torch, device, lane, final_mat, arrays, log)
    par = parallel_full_width(torch, device, width, arrays, lane, log)
    launched(par["launches"], ("gmm_loglikes", "align_forward", "gmm_stats"),
             "phase 20's sharded programs")
    lanefb = lane_fb_full_width(torch, device, width, lane, kernels, log)
    launched(lanefb["launches"], ("lattice_lane",), "phase 20's lane-major FB")
    del lane, arrays
    phase20_s = time.perf_counter() - t20
    log(f"phase 20 on {device}: {phase20_s:.1f} s")
    runs = (decode, train, lattice, nbest, generic, *rates.values(), tri["fixture"],
            tri["tri1"], tri["tri2b"], lda["train"], lda["decode"], tri["sat_fixture"],
            tri["delta_sat"], tri["lda_sat"], sat["train"],
            {"launches": sat["train"]["alimdl_launches"]}, sat["decode"], examples["yesno"],
            examples["yesno_reopened"], examples["full_pipeline"],
            {"launches": ls_all}, silprob, fronts, fronts["pitch"], adapt, par, lanefb)
    return {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(r["launches"][name] for r in runs),
         **kernels[name]} for name in SOURCES],
        "full_width": decode, "train": train, "lattice": lattice, "nbest": nbest,
        "generic": generic, "rates": rates, "tri": tri, "lda_train": lda["train"],
        "lda_decode": lda["decode"], "sat_train": sat["train"], "sat_decode": sat["decode"],
        "examples": examples, "librispeech": ls,
        "phase19": {"wall_s": phase19_s, "silprob": silprob,
                    "features": {k: v for k, v in fronts.items() if k != "device_functions"},
                    "adaptation": {k: v for k, v in adapt.items() if k != "device_functions"}},
        "phase20": {"wall_s": phase20_s, "tf32": tf32, "parallel": par, "lane_fb": lanefb},
        "device_functions": {**lda["device_functions"], **sat["device_functions"],
                             **fronts["device_functions"], **adapt["device_functions"]}}


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
    for key, what in (("full_width", "decode"), ("train", "EM training"),
                      ("lattice", "lattice decode"), ("nbest", "N-best decode"),
                      ("generic", "generic alignment"), ("lda_train", "tri2b EM training"),
                      ("lda_decode", "LDA decode"), ("sat_train", "SAT EM training"),
                      ("sat_decode", "fMLLR decode")):
        facts = report.pop(key)
        busy = facts["profile"]["device_busy_share"]
        launched = {k: n for k, n in facts["launches"].items() if n}
        print(f"full-width {what} on {card}: {facts['median_audio_s_per_s']:.1f} audio-s/s "
              f"(median of {len(facts['runs_s'])} runs of {facts['audio_s']:.0f} audio s); "
              f"device busy {100 * busy:.1f} % of one profiled run; launches in one run "
              f"{launched}")
        if key == "lattice":
            print(f"full-width lattices: {facts['survivors_per_frame_mean']:.2f} survivors per "
                  f"frame (max {facts['survivors_per_frame_max']}), arcs per lattice (min, mean, "
                  f"max) {facts['arcs_per_lattice']}; one decode_sweep_lattice of "
                  f"{facts['sweep_utts']} utterances over {facts['sweep_points']} grid points "
                  f"{facts['sweep_s']:.2f} s")
    for sr, facts in report.pop("rates").items():
        print(f"make_features at {sr} Hz ({facts['n_fft']} points) on {card}: "
              f"{facts['utts']} utterances in {facts['wall_s']:.3f} s, max abs difference "
              f"from the CPU {facts['max_abs_err_vs_cpu']:.3g}, K1 launches "
              f"{facts['launches']['mfcc_frames']}")
    tri = report.pop("tri")
    print(f"triphone stages on {card}: tri2b fixture words = the JAX package's for "
          f"{tri['fixture']['utts']} test utterances; tri1 test WER {tri['tri1']['wer']:.2f} % "
          f"({tri['tri1']['aligner']}); tri2b test WER {tri['tri2b']['wer']:.2f} % "
          f"({tri['tri2b']['aligner']}); SAT fixture words = the JAX package's for "
          f"{tri['sat_fixture']['utts']} test utterances; delta+SAT test WER "
          f"{tri['delta_sat']['wer']:.2f} %, LDA+MLLT+SAT {tri['lda_sat']['wer']:.2f} %")
    ex = report.pop("examples")
    print(f"Project examples on {card}: Yes-No WER {ex['yesno']['wer']:.2f} % in "
          f"{ex['yesno']['wall_s']:.1f} s ({ex['yesno']['ctm_rows']} CTM rows checked); full "
          f"pipeline WER " + ", ".join(f"{k} {w:.2f} % (JAX {ex['full_pipeline']['jax_wer'][k]:.2f})"
                                       for k, w in ex["full_pipeline"]["wer"].items())
          + f" in {ex['full_pipeline']['wall_s']:.1f} s")
    ls = report.pop("librispeech")
    corpus = ls["corpus"]
    print(f"Project at LibriSpeech-shaped width on {card} (examples/librispeech_shaped_torch.py): "
          f"{corpus['speakers']} speakers x ({LS_UTTS} + {LS_TEST_PER}) utterances, "
          f"{corpus['audio_s']} audio s; WER "
          + ", ".join(f"{k} {w['wer']:.2f} % (JAX {JAX_LIBRISPEECH_WER[k]})"
                      for k, w in ls["wer"].items())
          + f"; aligners {ls['aligner']}; device busy "
          f"{100 * ls['decode_profile']['device_busy_share']:.1f} % of the profiled tri1 decode; "
          f"card = plain versions over the mono and tri1 HCLGs "
          f"({ls['graphs']['tri1']['parity']}) and the tri1 training graphs "
          f"({ls['generic_parity']}) in {ls['parity_s']:.1f} s")
    for name, g in ls["graphs"].items():
        print(f"  HCLG({name}): {g['states']} states, {g['arcs']} arcs ({g['eps_free_arcs']} "
              f"epsilon-free, in-degree up to {g['max_in_degree']}); forward plan "
              f"{g['plan_rows']} rows of D = {g['plan_d']} (up to "
              f"{g['plan_max_rows_per_state']} a state), backward plan "
              f"{g['backward_plan_rows']} rows of D = {g['backward_plan_d']} (up to "
              f"{g['backward_plan_max_rows_per_state']})")
    print(f"  HCLGs of the ladder: {ls['hclg']}")
    for name, st in ls["stages"].items():
        rate = f", {st['audio_s_per_s']} audio-s/s" if "audio_s_per_s" in st else ""
        print(f"  {name}: {st['wall_s']} s in {st['calls']} calls{rate}; launches "
              f"{ls['launches'][name]}")
    p19 = report.pop("phase19")
    fr, ad, sil = p19["features"], p19["adaptation"], p19["silprob"]
    print(f"phase 19 on {card} in {p19['wall_s']:.1f} s: PLP + fbank + spectrogram of "
          f"{fr['audio_s']:.0f} audio s in {fr['wall_s']:.3f} s (launches "
          f"{ {k: n for k, n in fr['launches'].items() if n} }); make_features(pitch=True) of "
          f"{fr['pitch']['utts']} utterances in {fr['pitch']['wall_s']:.2f} s, max abs difference "
          f"from the CPU {fr['pitch']['max_abs_err_vs_cpu']:.3g}; adaptation in "
          f"{ad['wall_s']:.2f} s (regression classes per speaker {ad['classes']}, launches "
          f"{ {k: n for k, n in ad['launches'].items() if n} }); silprob decode WER "
          f"{sil['wer']:.2f} % (tri1 {sil['tri1_wer']:.2f} %) in {sil['wall_s']:.1f} s")
    p20 = report.pop("phase20")
    par, lfb = p20["parallel"], p20["lane_fb"]
    print(f"phase 20 on {card} in {p20['wall_s']:.1f} s: TF32 guard bit-equal "
          f"{ {k: v['bit_equal'] for k, v in p20['tf32'].items()} }; lane-major lattice FB "
          f"{lfb['ms']} ms (bound {lfb['bound_ms']:.4g} ms), {lfb['launches']['lattice_lane']} "
          f"launches, {lfb['packed_bytes']} packed bytes = the plain version's on "
          f"{lfb['plain_lanes']} lanes (plain {lfb['plain_s']:.2f} s)")
    for name, f in par["programs"].items():
        print(f"  {name} at world size 1 on {card}: {f['wall_ms']:.3f} ms wall, all-reduce "
              f"{f.get('all_reduce_ms')} ms, bound {f.get('bound_ms')} ms ({f.get('bound_by')}); "
              f"max abs err against the unsharded function {f['max_abs_err_vs_unsharded']}, "
              f"world size 2 against 1 {f['max_abs_err_ws2_vs_ws1']}")
    for name, f in report.pop("device_functions").items():
        print(f"{name} on {card}: {f['ms']:.4f} ms device, {f['wall_ms']:.3f} ms wall, "
              f"bound {f['bound_ms']:.4f} ms ({f['bound_by']}), max abs err {f['max_abs_err']:.3g}")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The plain references against the program's own paths at a tiny size on
the CPU (the program runs its kernels' plain versions there)."""

import math

import numpy as np
import pytest
import torch

from vbbench import models
from vbbench import traffic as TR
from vbbench.runners import lattice_decode as LD
from vbbench.runners import train_realign as TRN
from vbbench.reference import align as RA
from vbbench.reference import frontend as RF
from vbbench.reference import gmm as RG
from vbbench.reference import lattice as RL
from vbbench.reference.precision import TF32, round_tf32

CPU = torch.device("cpu")
FEAT = {"samp_freq": 16000, "frame_length_ms": 25.0, "frame_shift_ms": 10.0, "dither": 0.0,
        "preemph_coeff": 0.97, "num_mel_bins": 23, "low_freq": 20.0, "num_ceps": 13,
        "cepstral_lifter": 22.0, "use_energy": False, "delta_order": 2, "delta_window": 2}
SPEC = {"batch_utts": 6, "speakers": 2, "frames": 30, "tones": 3, "tone_hz": [100.0, 1500.0],
        "tone_amp": [500.0, 4000.0], "drift": 0.05, "noise": 80.0}


@pytest.mark.parametrize("use_energy", [False, True])
def test_features_match_the_program(use_energy):
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features

    feat = {**FEAT, "use_energy": use_energy}
    waves, utt2spk, ids = TR.kind("decode_batches").decode_batch(SPEC, feat,
                                                                 TR.generator(5, CPU, 1), CPU, 0)
    got = make_features(waves, utt2spk, LD.mfcc_options(feat), device=CPU, dither_seed=None)
    utts = sorted(got)
    batch, _nf = pad_features(got, utts)
    x = torch.from_numpy(np.stack([waves[u] for u in utts]))
    want = RF.features(x, ids, feat)
    assert batch.shape == want.shape == (6, 30, 39)
    assert float((batch.double() - want).abs().max()) < 2e-3


def test_delta_taps_are_kaldis():
    taps = RF.delta_taps(2, 2)
    np.testing.assert_allclose(taps[1], np.array([-2, -1, 0, 1, 2]) / 10.0)
    assert len(taps[2]) == 9 and abs(taps[2].sum()) < 1e-12
    np.testing.assert_allclose(taps[2], taps[2][::-1])


def _gmm(p=7, d=5, seed=3):
    gen = TR.generator(seed, CPU, 2)
    counts = np.array([1, 2, 3, 1, 4, 2, 2])[:p]
    centre = torch.randn((p, d), generator=gen, dtype=torch.float64)
    return models.draw_gmm(gen, CPU, counts, centre, 0.3, torch.ones(d, dtype=torch.float64),
                           0.5, 1.5, "dirichlet")


def test_gmm_loglikes_match_the_program():
    from voicebridge_tpu_torch.ops import gmm_kernels

    g = _gmm()
    x = torch.randn((50, 5), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want = RG.Scorer(g, CPU).loglikes(x)
    got = gmm_kernels.loglikes(gmm_kernels.pack_gmm(models.to_am(g), CPU), x.float())
    assert float((got.double() - want).abs().max()) < 1e-3
    # a single Gaussian's log-density, written out
    one = {k: v[:1, :1] for k, v in g.items()}
    one["weights"] = np.ones((1, 1))
    mean, var = one["means"][0, 0], one["vars"][0, 0]
    x0 = x[0].numpy()
    dens = -0.5 * (np.log(2 * np.pi * var) + (x0 - mean) ** 2 / var).sum()
    assert float(RG.Scorer(one, CPU).loglikes(x[:1])[0, 0]) == pytest.approx(dens, abs=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 3.0]
    assert TF32.mm(x[None], x[:, None]).dtype == torch.float32


def test_lattice_reference_matches_the_program():
    from voicebridge_tpu_torch import DecodeOptions
    from voicebridge_tpu_torch.steps.decode import Decoder

    gen = TR.generator(9, CPU, 3)
    graph = models.decode_graph(gen, CPU, 200, 8, 7, 12)
    g = _gmm()
    feats = torch.randn((3, 25, 5), generator=torch.Generator().manual_seed(2))
    dec = Decoder.from_dense_graph(models.to_dense_graph(graph), models.to_am(g),
                                   DecodeOptions(acoustic_scale=0.1, lattice_beam=4.0),
                                   device=CPU, row_width=8)
    utts = ["a", "b", "c"]
    lats = dec.decode_lattice(utts, feats, torch.tensor([25, 25, 25]))
    ll = torch.stack([RG.Scorer(g, CPU).loglikes(f.double()) for f in feats])
    want = []

    def visit(t, margin):
        want.append((t, margin))

    RL.forward_backward(graph, ll, 0.1, 4.0, visit=visit)
    for i, u in enumerate(utts):
        got = {(int(t), int(a)) for t, a in zip(lats[u].arc_t, lats[u].arc_id)}
        ref = {(t, int(a)) for t, m in want for a in torch.nonzero(m[i] >= 0)[:, 0]}
        near = {(t, int(a)) for t, m in want for a in torch.nonzero(m[i].abs() < 1e-3)[:, 0]}
        assert got ^ ref <= near and len(got) > 25


def test_alignment_reference_matches_the_program():
    from voicebridge_tpu_torch.steps.align import AlignmentSet

    cfg = {"topology": {"probs": {"self": 0.75, "next": 0.2, "skip": 0.05}},
           "train": {"self_loop_scale": 0.1, "transition_scale": 1.0}}
    rng = np.random.default_rng(4)
    ns = np.array([6, 9, 4])
    corpus = {"num_states": ns, "state_pdf": rng.integers(0, 7, ns.sum()).astype(np.int32),
              "skip": (rng.random(ns.sum()) < 0.3) & (np.concatenate(
                  [np.arange(n) for n in ns]) >= 2)}
    base = (1 + 3 * np.arange(7))[corpus["state_pdf"]]
    graphs = TRN.chain_graphs(corpus, base, TRN.arc_scores(cfg))
    nf = np.array([20, 25, 11], np.int32)
    ll = torch.randn((3, 25, 7), generator=torch.Generator().manual_seed(3))
    res = AlignmentSet(graphs, device=CPU).align(ll, nf, acoustic_scale=0.5)
    sc = torch.as_tensor(TRN.arc_scores(cfg), dtype=torch.float64)
    s_max = int(ns.max())
    w = torch.full((3, 3, s_max), -math.inf, dtype=torch.float64)
    emit = torch.zeros((3, 25, s_max), dtype=torch.float64)
    first = np.cumsum(ns) - ns
    kinds = torch.zeros((3, 25), dtype=torch.long)
    for j in range(3):
        pdf = corpus["state_pdf"][first[j]:first[j] + ns[j]]
        emit[j, :, :ns[j]] = 0.5 * ll[j][:, pdf].double()
        w[j, 0, :ns[j]] = sc[0]
        w[j, 1, 1:ns[j]] = sc[1]
        skip = torch.as_tensor(corpus["skip"][first[j]:first[j] + ns[j]])
        w[j, 2, :ns[j]] = torch.where(skip, sc[2], torch.tensor(-math.inf, dtype=torch.float64))
        tid = np.asarray(res[j]["tids"])
        kinds[j, :len(tid)] = torch.as_tensor((tid - 1) % 3)
    nf_t, ns_t = torch.as_tensor(nf), torch.as_tensor(ns)
    best = RA.best_scores(w, emit, nf_t, ns_t)
    got = RA.path_scores(w, emit, kinds, nf_t, ns_t)
    assert torch.allclose(best, got, atol=1e-4)
    assert torch.allclose(RA.path_scores(w, emit, RA.best_paths(w, emit, nf_t, ns_t), nf_t, ns_t),
                          best, atol=1e-9)


def test_mle_update_and_mixup_match_the_program():
    g = _gmm()
    rng = np.random.default_rng(6)
    occ = rng.uniform(0.0, 60.0, g["weights"].shape) * (g["weights"] > 0)
    occ[0, 0] = 5.0  # under the occupancy floor, but the pdf's only Gaussian
    occ[4, 1] = 3.0  # under the floor: dropped
    sx = rng.standard_normal(g["means"].shape) * occ[..., None]
    sxx = (rng.uniform(0.5, 2.0, g["means"].shape) + (sx / np.maximum(occ, 1e-10)[..., None]) ** 2) \
        * occ[..., None]
    am = models.to_am(g)
    am.mle_update(occ.astype(np.float32), sx.astype(np.float32), sxx.astype(np.float32), 10.0,
                  0.001)
    am.split_to_target(16, occ.astype(np.float32), power=0.25, seed=7)
    want = RG.mix_up(RG.mle_update(g, occ, sx, sxx, 10.0, 0.001), 16, occ, 0.25, seed=7)
    got = models.from_am(am)
    m = max(got["weights"].shape[1], want["weights"].shape[1])
    assert got["weights"].shape[1] == m == want["weights"].shape[1]
    np.testing.assert_allclose(got["weights"], want["weights"], atol=1e-6)
    live = want["weights"] > 0
    np.testing.assert_allclose(got["means"][live], want["means"][live], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["vars"][live], want["vars"][live], rtol=1e-4)


def test_transition_update_matches_the_program():
    from voicebridge_tpu_torch.models.transition import TransitionModel

    cfg = {"topology": {"num_phones": 2, "states_per_phone": 3,
                        "probs": {"self": 0.75, "next": 0.2, "skip": 0.05}}}
    tree = TRN.Tree(6, [np.array([i]) for i in range(6)], 3)
    tm = TransitionModel(TRN.topology(cfg), tree)
    counts = np.random.default_rng(1).uniform(0, 9, tm.num_transition_ids + 1)
    lp0 = tm.log_probs.copy()
    tm.mle_update(counts)
    want = RG.transition_update(lp0, 1 + 3 * np.arange(7), counts)
    np.testing.assert_allclose(tm.log_probs[1:], want[1:], atol=1e-6)
    assert (TRN.tuple_ranks(tree.members, 3, 6) == np.arange(6)).all()

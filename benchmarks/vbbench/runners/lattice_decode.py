"""Lattice decode through the program's serving path, one client in a
closed loop: each request is a batch of waves on the host, and its product
is the ``Lattice`` objects on the host.

Per request: ``steps/make_feats.make_features`` + ``pad_features`` (span
``features``), then ``Decoder.decode_lattice`` (span ``decode``).  The
correctness comparison takes a sample of the requests completed in the
window, drawn from the seed: their features against the plain features, and
their lattices (surviving arcs and acoustic costs) against the plain
forward-backward over the plain log-likelihoods, all in float64.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import counts, judge, models
from .. import traffic as TR
from ..record import Compared
from ..reference import frontend as RF
from ..reference import gmm as RG


def mfcc_options(feat: dict):
    from voicebridge_tpu_torch import FrameOptions, MelOptions, MfccOptions

    return MfccOptions(
        frame_opts=FrameOptions(samp_freq=float(feat["samp_freq"]),
                                frame_shift_ms=float(feat["frame_shift_ms"]),
                                frame_length_ms=float(feat["frame_length_ms"]),
                                dither=float(feat["dither"]),
                                preemph_coeff=float(feat["preemph_coeff"])),
        mel_opts=MelOptions(num_bins=int(feat["num_mel_bins"]), low_freq=float(feat["low_freq"])),
        num_ceps=int(feat["num_ceps"]), cepstral_lifter=float(feat["cepstral_lifter"]),
        use_energy=bool(feat["use_energy"]))


def decode_gmm(cfg: dict, x64: torch.Tensor, gen, device) -> dict:
    """The GMM on the scale of plain features ``x64 [N, D]``: Gaussians per
    pdf allotted to the occupancy shares to ``mixup_power``, means at the
    features' mean + their deviation * N(0, 1), variances the features'
    divided by ``var_divisor`` times U(0.5, 2), equal weights."""
    m = cfg["model"]
    mean, var = x64.mean(0), x64.var(0)
    shares = models.occupancy_shares(gen, m["num_pdfs"], m["occupancy_sigma"], device)
    n = models.allot(shares, m["num_gauss"], m["mixup_power"])
    p = m["num_pdfs"]
    return models.draw_gmm(gen, device, n, mean[None].expand(p, -1), var.sqrt(),
                           var / m["var_divisor"], 0.5, 2.0, "equal")


class Runner:
    def __init__(self, run):
        self.run = run
        self.cfg, self.spec = run.config, run.traffic
        self.feat = self.cfg["features"]

    def setup(self) -> None:
        from voicebridge_tpu_torch import DecodeOptions
        from voicebridge_tpu_torch.steps.decode import Decoder

        run, cfg, spec, dev = self.run, self.cfg, self.spec, self.run.device
        mark = time.perf_counter()
        gw = TR.generator(run.seed, dev, 1)
        self.pool = TR.kind(spec["kind"]).requests(spec, self.feat, gw, dev)
        waves0, _spk0, ids0 = self.pool[0]
        x64 = RF.features(self.stack(waves0), ids0, self.feat)
        self.gmm = decode_gmm(cfg, x64.reshape(-1, x64.shape[2]), TR.generator(run.seed, dev, 2),
                              dev)
        del x64
        run.phases["waves and model"] = time.perf_counter() - mark
        mark = time.perf_counter()
        g = cfg["graph"]
        self.graph = models.decode_graph(TR.generator(run.seed, dev, 3), dev, g["num_states"],
                                         g["arcs_per_state"], cfg["model"]["num_pdfs"],
                                         g["max_jump"])
        d = cfg["decode"]
        self.opts = mfcc_options(self.feat)
        self.dec = Decoder.from_dense_graph(
            models.to_dense_graph(self.graph), models.to_am(self.gmm),
            DecodeOptions(acoustic_scale=float(d["acoustic_scale"]),
                          lattice_beam=float(d["lattice_beam"])),
            device=dev, row_width=int(g["row_width"]))
        run.phases["graph and decoder"] = time.perf_counter() - mark
        mark = time.perf_counter()
        gen = torch.Generator().manual_seed(int(run.seed) % (1 << 63))
        self.order = torch.randperm(len(self.pool), generator=gen).tolist()
        self.kept: dict = {}
        for k in self.order[: int(spec["warmup_batches"])]:
            self.request(k, record=False)
        run.phases["warm-up requests"] = time.perf_counter() - mark

    def stack(self, waves: dict) -> torch.Tensor:
        """A request's waves ``[B, N]`` in utterance order: the plain
        front end here takes utterances of one length."""
        if len({len(w) for w in waves.values()}) != 1:
            raise ValueError("this runner's reference takes requests of equal-length utterances")
        return torch.from_numpy(np.stack([waves[u] for u in sorted(waves)])).to(self.run.device)

    def request(self, k: int, record: bool = True) -> None:
        from voicebridge_tpu_torch.steps import make_feats

        run = self.run
        waves, utt2spk, _ids = self.pool[k]
        t0 = time.perf_counter()
        with run.span("features"):
            feats = make_feats.make_features(waves, utt2spk, self.opts, device=run.device,
                                             dither_seed=None)
            utts = sorted(feats)
            batch, nf = make_feats.pad_features(feats, utts)
        with run.span("decode"):
            lats = self.dec.decode_lattice(utts, batch, nf)
        latency = time.perf_counter() - t0
        if not record:
            return
        nf = np.asarray(nf.cpu())
        frames = int(nf.sum())
        arcs = sum(lats[u].num_arcs for u in utts if u in lats)
        run.requests.append(("decode", frames * 0.01, latency))
        run.attempted += len(utts)
        run.failed += sum(1 for u in utts if u not in lats or lats[u].num_arcs == 0
                          or not np.isfinite(lats[u].acoustic_cost).all())
        run.count("frames", frames)
        run.count("survivor_arcs", arcs)
        m, g = self.cfg["model"], self.graph
        ws, _shift, n_fft = RF.frame_geometry(self.feat)
        run.add_work("features", *counts.mfcc(frames, ws, n_fft, int(self.feat["num_mel_bins"]),
                                              int(self.feat["num_ceps"]),
                                              sum(len(w) for w in waves.values())))
        run.add_work("acoustic_scoring", *counts.gmm(frames, m["num_gauss"], batch.shape[2],
                                                     m["num_pdfs"]))
        run.add_work("lattice", *counts.lattice(frames, 1, len(g["src"]), m["num_pdfs"], arcs,
                                                16 * len(g["src"])))
        self.kept[k] = (batch, [(lats[u].arc_t, lats[u].arc_id, lats[u].acoustic_cost)
                                if u in lats else ([], [], []) for u in utts])

    def window(self, deadline: float) -> None:
        i = 0
        while time.perf_counter() < deadline:
            self.request(self.order[i % len(self.order)])
            i += 1

    # -- the correctness comparison ------------------------------------------

    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""
        self.dec = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """[(pool index, [utterance indices])]: requests completed in the
        window and utterances of each, drawn from the seed."""
        ch = self.run.cell["check"]
        gen = torch.Generator().manual_seed((int(self.run.seed) * 31 + 7) % (1 << 63))
        done = sorted(self.kept)
        picks = [done[j] for j in torch.randperm(len(done), generator=gen).tolist()]
        b = int(self.spec["batch_utts"])
        return [(k, sorted(torch.randperm(b, generator=gen)[: int(ch["utts_per_batch"])]
                           .tolist())) for k in picks[: int(ch["batches"])]]

    def program_outputs(self, sample: list) -> list:
        """[(features [B, T, D], {utterance index: (frames, arcs, costs)})]
        of the sampled requests, as the timed path produced them."""
        return [(self.kept[k][0], {i: self.kept[k][1][i] for i in utts}) for k, utts in sample]

    def check(self) -> None:
        self.free_program()
        sample = self.sample()
        self.run.compared = self.judge(sample, self.program_outputs(sample))

    def judge(self, sample: list, outputs: list) -> list:
        """The compared numbers of the sampled requests' outputs against the
        float64 references."""
        run, cfg, limits = self.run, self.cfg, self.run.cell["limits"]
        feat_err, ll_rows, lats = 0.0, [], []
        scorer = RG.Scorer(self.gmm, run.device)
        for (k, utts), (feats, lat_by_utt) in zip(sample, outputs):
            waves, _utt2spk, ids = self.pool[k]
            ref = RF.features(self.stack(waves), ids, self.feat)
            feat_err = max(feat_err, judge.max_abs(feats, ref))
            for i in utts:
                ll_rows.append(scorer.loglikes(ref[i]))
                lats.append(lat_by_utt[i])
        d = cfg["decode"]
        nums = judge.lattice_numbers(self.graph, torch.stack(ll_rows), float(d["acoustic_scale"]),
                                     float(d["lattice_beam"]), lats)
        return [Compared("feat_err", feat_err, limits["feat_err"]),
                Compared("cost_err", nums["cost_err"], limits["cost_err"]),
                Compared("lat_miss", nums["lat_miss"], limits["lat_miss"])]

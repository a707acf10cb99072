"""Two-pass fMLLR decode through the program's serving path, one client in
a closed loop: each request is a batch of waves on the host from a few
speakers, and its product is the ``DecodeResult`` of every utterance on the
host (``steps/decode_fmllr.sh`` over a speaker-complete batch).

Per request: ``make_features`` without deltas (13 MFCC, per-speaker CMVN),
``lda_decode_feats`` (splice +-3, the LDA+MLLT matrix) and ``pad_features``
(span ``features``), then ``FmllrDecoder.decode`` (span ``decode``): the
speaker-independent lattice pass, posteriors, statistics and row solves,
the adapted pass, a second estimate, rescoring and pruned determinization.

The correctness comparison takes whole speakers (fMLLR is per speaker) of
requests completed in the window, drawn from the seed, and follows the
program stage by stage in float64 (``reference/fmllr.py``), each stage fed
the program's own inputs to it:

* ``feat_err``: the features of the adapted pass and the final features
  against the plain front end's with the reference's transforms, estimated
  from the program's lattices;
* ``cost_err``: the lattices' acoustic costs (both passes and the rescored
  ones) against -log-likelihood64 of the program's features for them, and
  the determinized best path's score against the plain best path over the
  rescored arcs (a word sequence that differs reads inf);
* ``lat_miss``: both passes' lattices against the plain forward-backward.
"""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import counts, judge, models, word_graph
from .. import traffic as TR
from ..record import Compared
from ..reference import fmllr as RFM
from ..reference import frontend as RF
from ..reference import gmm as RG
from .lattice_decode import mfcc_options
from .train_realign import Tree, draw_roots, topology, tuple_ranks

SCORE_BLOCK = 1024  # frames a block of the float64 log-likelihoods: [1024, P * M] float64


def splice(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``[B, T, D] -> [B, T, D (left + right + 1)]``, frame indices clamped
    to the utterance (``splice-feats``; every utterance T frames)."""
    t = x.shape[1]
    idx = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(-left, right + 1, device=x.device)[None]).clamp(0, t - 1)
    return x[:, idx].reshape(x.shape[0], t, -1)


def lda_features(waves: torch.Tensor, speaker: np.ndarray, feat: dict, mat: np.ndarray,
                 prec=None) -> torch.Tensor:
    """The plain front end of the decode: MFCC -> CMVN per speaker -> splice
    -> the affine LDA+MLLT matrix ``[E, 91 + 1]``, in float64 (or ``prec``)."""
    prec = prec or RG.EXACT
    x = RF.cmvn(RF.mfcc(waves, feat, prec), speaker)
    x = splice(x, int(feat["splice_left"]), int(feat["splice_right"]))
    m = prec.t(torch.as_tensor(mat)).to(x.device)
    b, t, d = x.shape
    return (prec.mm(x.reshape(b * t, d), m[:, :-1].T) + m[:, -1]).view(b, t, -1)


def draw_lda(gen, device, x: torch.Tensor, dim: int) -> np.ndarray:
    """``[dim, D + 1]`` float32: ``dim`` orthonormal directions of the
    spliced space (normal rows, orthonormalized) over the features'
    deviations, the offset column taking their mean."""
    flat = x.reshape(-1, x.shape[-1])
    mean, std = flat.mean(0), flat.std(0).clamp_min(1e-6)
    q, _ = torch.linalg.qr(torch.randn((flat.shape[1], dim), generator=gen, device=device,
                                       dtype=torch.float64))
    a = q.T / std[None]
    return torch.cat([a, -(a @ mean)[:, None]], dim=1).float().cpu().numpy()


def refit(gmm: dict, x: torch.Tensor, pdf: torch.Tensor, min_occ: float,
          var_floor: np.ndarray) -> dict:
    """The GMM with every Gaussian of ``min_occ`` frames or more of the
    aligned frames re-estimated (mean; variance floored at ``var_floor``),
    the rest and the weights kept: the Gaussian count stays."""
    occ, sx, sxx, _ = RG.aligned_stats(gmm, x, pdf, torch.ones(len(pdf), dtype=torch.float64,
                                                                device=x.device))
    ok = (occ >= min_occ) & (gmm["weights"] > 0)
    n = np.maximum(occ, 1e-10)[..., None]
    mean = sx / n
    var = np.maximum(sxx / n - mean * mean, var_floor)
    return {"means": np.where(ok[..., None], mean, gmm["means"]),
            "vars": np.where(ok[..., None], var, gmm["vars"]),
            "weights": gmm["weights"].copy(), "refit": int(ok.sum())}


class Runner:
    def __init__(self, run):
        self.run = run
        self.cfg, self.spec = run.config, run.traffic
        self.feat = self.cfg["features"]

    def setup(self) -> None:
        # the program's serving object first: a program without it stops here
        from voicebridge_tpu_torch.steps.decode_fmllr import FmllrDecoder
        from voicebridge_tpu_torch import DecodeOptions
        from voicebridge_tpu_torch.config import FmllrDecodeOptions
        from voicebridge_tpu_torch.models.transition import TransitionModel
        from voicebridge_tpu_torch.steps.decode import Decoder

        run, cfg, spec, dev = self.run, self.cfg, self.spec, self.run.device
        m, topo, fm, d = cfg["model"], cfg["topology"], cfg["fmllr"], cfg["decode"]
        mark = time.perf_counter()
        gw = TR.generator(run.seed, dev, 1)
        self.pool = TR.kind(spec["kind"]).requests(spec, self.feat, gw, dev)
        waves0, _spk0, ids0 = self.pool[0]
        spliced = splice(RF.cmvn(RF.mfcc(self.stack(waves0), self.feat), ids0),
                         int(self.feat["splice_left"]), int(self.feat["splice_right"]))
        self.lda = draw_lda(TR.generator(run.seed, dev, 4), dev, spliced, int(cfg["lda"]["dim"]))
        del spliced
        x64 = lda_features(self.stack(waves0), ids0, self.feat, self.lda)
        flat = x64.reshape(-1, x64.shape[2])
        mean, var = flat.mean(0), flat.var(0)
        gm = TR.generator(run.seed, dev, 2)
        self.roots = draw_roots(cfg, gm, dev)
        n = models.allot(self.roots["occ"], m["num_gauss"], m["mixup_power"])
        p = m["num_pdfs"]
        self.alimdl = models.draw_gmm(gm, dev, n, mean[None].expand(p, -1), var.sqrt(),
                                      var / m["var_divisor"], 0.5, 2.0, "equal")
        spp = topo["states_per_phone"]
        self.rank = tuple_ranks(self.roots["member_list"], spp, p)
        self.tm = TransitionModel(topology(cfg), Tree(p, self.roots["member_list"], spp))
        run.phases["waves, matrix and alignment model"] = time.perf_counter() - mark
        mark = time.perf_counter()
        g = cfg["graph"]
        self.graph = word_graph.decode_graph(TR.generator(run.seed, dev, 3), dev, g, p,
                                             self.rank)
        self.dense = word_graph.to_dense_graph(self.graph)
        run.phases["graph"] = time.perf_counter() - mark
        mark = time.perf_counter()
        # final.mdl: alimdl refit on its own best paths through the first request
        si = Decoder.from_dense_graph(self.dense, models.to_am(self.alimdl),
                                      DecodeOptions(acoustic_scale=float(d["acoustic_scale"])),
                                      device=dev, row_width=int(g["row_width"]))
        utts0 = sorted(waves0)
        nf0 = np.full(len(utts0), x64.shape[1])
        best = si.decode_batch(utts0, x64.float(), nf0, keep_tids=True)
        del si
        pdf_of_tid = np.asarray(self.tm.tid2pdf)
        pdf = torch.as_tensor(np.concatenate([pdf_of_tid[np.asarray(r.tids)] for r in best]),
                              device=dev)
        floor = (var / (2 * m["var_divisor"])).cpu().numpy()
        self.final = refit(self.alimdl, flat, pdf, float(m["min_gaussian_occupancy"]), floor)
        run.phases["final model"] = time.perf_counter() - mark
        del x64, flat, best
        mark = time.perf_counter()
        self.opts = mfcc_options(self.feat)
        self.dopts = FmllrDecodeOptions(fmllr_update_type=fm["update_type"],
                                        fmllr_min_count=float(fm["min_count"]),
                                        silence_weight=float(fm["silence_weight"]),
                                        acoustic_scale=float(d["acoustic_scale"]),
                                        lattice_beam=float(d["lattice_beam"]))
        self.lang = SimpleNamespace(silence_phone_ids=list(range(1, int(topo["silence_phones"])
                                                                 + 1)))
        self.dec = FmllrDecoder(self.dense, self.tm, models.to_am(self.final),
                                models.to_am(self.alimdl), self.lang, self.dopts, device=dev)
        run.phases["decoder"] = time.perf_counter() - mark
        mark = time.perf_counter()
        gen = torch.Generator().manual_seed(int(run.seed) % (1 << 63))
        self.order = torch.randperm(len(self.pool), generator=gen).tolist()
        self.kept: dict = {}
        self.stages: list = []  # each request's stage seconds, printed with the check
        for k in self.order[: int(spec["warmup_batches"])]:
            self.request(k, record=False)
        run.phases["warm-up requests"] = time.perf_counter() - mark

    def stack(self, waves: dict) -> torch.Tensor:
        """A request's waves ``[B, N]`` in utterance order (utterances of one
        length)."""
        if len({len(w) for w in waves.values()}) != 1:
            raise ValueError("this runner's reference takes requests of equal-length utterances")
        return torch.from_numpy(np.stack([waves[u] for u in sorted(waves)])).to(self.run.device)

    def request(self, k: int, record: bool = True) -> None:
        from voicebridge_tpu_torch.steps import make_feats
        from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats

        run = self.run
        waves, utt2spk, _ids = self.pool[k]
        t0 = time.perf_counter()
        with run.span("features"):
            base = make_feats.make_features(waves, utt2spk, self.opts, deltas=None,
                                            device=run.device, dither_seed=None)
            feats = lda_decode_feats(base, self.lda, device=run.device)
            utts = sorted(feats)
            batch, nf = make_feats.pad_features(feats, utts)
        keep: dict = {}
        stages: dict = {}
        with run.span("decode"):
            results, _trans = self.dec.decode(utts, batch, nf, utt2spk, keep=keep,
                                              stage_s=stages)
        latency = time.perf_counter() - t0
        if not record:
            return
        self.stages.append(stages)
        nf = np.asarray(nf.cpu())
        frames = int(nf.sum())
        run.requests.append(("decode", frames * 0.01, latency))
        run.attempted += len(utts)
        run.failed += sum(1 for r, n in zip(results, nf) if not math.isfinite(r.score)
                          or len(r.tids) != n)
        arcs = [sum(lats[u].num_arcs for u in utts)
                for lats in (keep["si_lattices"], keep["adapted_lattices"])]
        run.count("frames", frames)
        run.count("survivor_arcs", sum(arcs))
        m, g = self.cfg["model"], self.graph
        ws, _shift, n_fft = RF.frame_geometry(self.feat)
        run.add_work("features", *counts.mfcc(frames, ws, n_fft, int(self.feat["num_mel_bins"]),
                                              int(self.feat["num_ceps"]),
                                              sum(len(w) for w in waves.values())))
        # K2 three times: the two lattice passes and the rescoring
        run.add_work("acoustic_scoring", *counts.gmm(3 * frames, m["num_gauss"], batch.shape[2],
                                                     m["num_pdfs"]))
        for n_arcs in arcs:
            run.add_work("lattice", *counts.lattice(frames, 1, len(g["src"]), m["num_pdfs"],
                                                    n_arcs, 16 * len(g["src"])))
        self.kept[k] = {"utts": utts, "results": results, "base": batch,
                        **{key: keep[key] for key in ("si_lattices", "adapted_lattices",
                                                      "rescored", "adapted1", "adapted2")}}

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
        window and whole speakers of each, drawn from the seed."""
        ch = self.run.cell["check"]
        gen = torch.Generator().manual_seed((int(self.run.seed) * 31 + 13) % (1 << 63))
        done = sorted(self.kept)
        picks = [done[j] for j in torch.randperm(len(done), generator=gen).tolist()]
        spk = int(self.spec["speakers"])
        per = int(self.spec["batch_utts"]) // spk
        out = []
        for k in picks[: int(ch["requests"])]:
            chosen = sorted(torch.randperm(spk, generator=gen)[: int(ch["speakers_per_request"])]
                            .tolist())
            out.append((k, [s * per + i for s in chosen for i in range(per)]))
        return out

    def program_outputs(self, sample: list) -> list:
        """Per sampled request, the sampled utterances' stage outputs as the
        timed path produced them: base features, the features of both
        passes (``[n, T, D]`` tensors), the SI, adapted and rescored
        lattices as (frames, arcs, acoustic costs), and the best paths as
        (score, words)."""
        out = []
        for k, idx in sample:
            kk = self.kept[k]
            names = [kk["utts"][i] for i in idx]
            rows = torch.as_tensor(idx, device=kk["base"].device)

            def arrays(lats):
                return [(lats[u].arc_t, lats[u].arc_id, lats[u].acoustic_cost) for u in names]

            out.append({"base": kk["base"][rows], "adapted1": kk["adapted1"][rows],
                        "adapted2": kk["adapted2"][rows], "si": arrays(kk["si_lattices"]),
                        "adapted": arrays(kk["adapted_lattices"]),
                        "rescored": arrays(kk["rescored"]),
                        "best": [(kk["results"][i].score, list(kk["results"][i].words))
                                 for i in idx]})
        return out

    def check(self) -> None:
        t0 = time.perf_counter()
        sample = self.sample()
        outputs = self.program_outputs(sample)
        self.free_program()
        self.run.compared = self.judge(sample, outputs)
        print(f"check: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        for name in (self.stages[0] if self.stages else {}):
            print(f"stage: {name} " + " ".join(f"{st[name]:.3f}" for st in self.stages),
                  file=sys.stderr)

    def silence_arcs(self) -> np.ndarray:
        """Each graph arc's flag: its transition id's phone is a silence
        phone."""
        phone = np.asarray(self.tm.tid2phone)[self.graph["tid"]]
        return phone <= int(self.cfg["topology"]["silence_phones"])

    def transform(self, lats: list, base64: torch.Tensor, prec=RFM.EXACT) -> torch.Tensor:
        """The reference's transform ``[D, D+1]`` of one speaker from its
        lattices' posteriors on its base features ``[n, T, D]``."""
        fm, acwt = self.cfg["fmllr"], float(self.cfg["decode"]["acoustic_scale"])
        pdf, w = RFM.lattice_posteriors(self.graph, lats, base64.shape[1], acwt,
                                        self.silence_arcs(), float(fm["silence_weight"]),
                                        prec=prec, device=self.run.device)
        beta, k, g = RFM.fmllr_stats(self.final, base64.reshape(-1, base64.shape[2]),
                                     pdf.reshape(len(base64) * base64.shape[1], -1),
                                     w.reshape(len(base64) * base64.shape[1], -1), prec)
        return RFM.fmllr_solve(float(beta), k.cpu(), g.cpu(), float(fm["min_count"]))

    def judge(self, sample: list, outputs: list) -> list:
        """The compared numbers of the sampled speakers' stage outputs
        against the float64 references, each stage fed the outputs' inputs
        to it."""
        cfg, limits, dev = self.cfg, self.run.cell["limits"], self.run.device
        acwt, beam = float(cfg["decode"]["acoustic_scale"]), float(cfg["decode"]["lattice_beam"])
        feat_err, cost_err, lat_miss = 0.0, 0.0, 0.0
        pdf_of_arc = torch.as_tensor(self.graph["pdf"], device=dev).long()

        def ll64(gmm, x):
            n, t, d = x.shape
            return RFM.loglikes(gmm, x.reshape(n * t, d).double(), block=SCORE_BLOCK).view(n, t, -1)

        for (k, idx), o in zip(sample, outputs):
            waves, _utt2spk, ids = self.pool[k]
            ref = lda_features(self.stack(waves), ids, self.feat, self.lda)[
                torch.as_tensor(idx, device=dev)]
            for model, feats, lats in ((self.alimdl, o["base"], o["si"]),
                                       (self.final, o["adapted1"], o["adapted"])):
                nums = judge.lattice_numbers(self.graph, ll64(model, feats), acwt, beam, lats)
                cost_err, lat_miss = max(cost_err, nums["cost_err"]), max(lat_miss,
                                                                          nums["lat_miss"])
            for lats, got in ((o["si"], o["adapted1"]), (o["adapted"], o["adapted2"])):
                want = RFM.apply_transform(self.transform(lats, ref).to(dev), ref)
                feat_err = max(feat_err, judge.max_abs(got, want))
            ll = ll64(self.final, o["adapted2"])
            for i, ((ft, arc, cost), (score, words)) in enumerate(zip(o["rescored"], o["best"])):
                ft = torch.as_tensor(np.asarray(ft), device=dev).long()
                arc = torch.as_tensor(np.asarray(arc), device=dev).long()
                want = -ll[i, ft, pdf_of_arc[arc]]
                cost_err = max(cost_err, judge.max_abs(torch.as_tensor(np.asarray(cost),
                                                                       device=dev), want))
                best, best_words = RFM.best_path(self.graph, o["rescored"][i], ref.shape[1], acwt)
                gap = abs(score - best)
                # another word sequence counts only as a tie with the best
                cost_err = max(cost_err, gap if words == best_words or gap <= TIE else math.inf)
        return [Compared("feat_err", feat_err, limits["feat_err"]),
                Compared("cost_err", cost_err, limits["cost_err"]),
                Compared("lat_miss", lat_miss, limits["lat_miss"])]

    def control_outputs(self, sample: list, prec=None, block: int = 16) -> list:
        """The stage outputs of the sampled speakers from the references in
        TF32 in the program's place (``reference.precision.TF32``: the
        front end, the scoring and the transforms' products in TF32, the
        rest in float32), in ``program_outputs``' form."""
        from ..reference.precision import TF32

        prec = prec or TF32
        cfg, dev = self.cfg, self.run.device
        acwt, beam = float(cfg["decode"]["acoustic_scale"]), float(cfg["decode"]["lattice_beam"])
        pdf_of_arc = torch.as_tensor(self.graph["pdf"], device=dev).long()

        def lattices(model, x):
            n, t, d = x.shape
            ll = RFM.loglikes(model, x.reshape(n * t, d), prec, SCORE_BLOCK).view(n, t, -1)
            found = [[] for _ in range(n)]
            for lo in range(0, n, block):
                part = found[lo:lo + block]

                def visit_part(f, margin, part=part):
                    lane, arc = torch.nonzero(margin >= 0, as_tuple=True)
                    for i in range(len(part)):
                        part[i].append((torch.full_like(arc[lane == i], f), arc[lane == i]))

                RFM.forward_backward(self.graph, ll[lo:lo + block], acwt, beam, visit_part, prec)
            out = []
            for i, parts in enumerate(found):
                ft = torch.cat([f for f, _ in parts])
                arc = torch.cat([a for _, a in parts])
                order = torch.argsort(ft, stable=True)
                ft, arc = ft[order], arc[order]
                out.append((ft.cpu().numpy(), arc.cpu().numpy(),
                            (-ll[i, ft, pdf_of_arc[arc]]).float().cpu().numpy()))
            return out

        outs = []
        for k, idx in sample:
            waves, _utt2spk, ids = self.pool[k]
            base = lda_features(self.stack(waves), ids, self.feat, self.lda, prec)[
                torch.as_tensor(idx, device=dev)]
            si = lattices(self.alimdl, base)
            adapted1 = RFM.apply_transform(self.transform(si, base, prec).to(dev), base, prec)
            adapted = lattices(self.final, adapted1)
            adapted2 = RFM.apply_transform(self.transform(adapted, base, prec).to(dev), base,
                                           prec)
            n, t, d = adapted2.shape
            ll = RFM.loglikes(self.final, adapted2.reshape(n * t, d), prec,
                              SCORE_BLOCK).view(n, t, -1)
            rescored = []
            for i, (ft, arc, _cost) in enumerate(adapted):
                ftt = torch.as_tensor(ft, device=dev).long()
                at = torch.as_tensor(arc, device=dev).long()
                rescored.append((ft, arc, (-ll[i, ftt, pdf_of_arc[at]]).float().cpu().numpy()))
            best = [RFM.best_path(self.graph, lat, t, acwt, prec) for lat in rescored]
            outs.append({"base": base, "adapted1": adapted1, "adapted2": adapted2, "si": si,
                         "adapted": adapted, "rescored": rescored, "best": best})
        return outs

    def readings(self, control: bool = False, faults: bool = False) -> list:
        """[(reading, [Compared])] after the window: the program's, with
        ``control`` the TF32 references', with ``faults`` each planted
        fault's (``FAULTS``)."""
        sample = self.sample()
        prog = self.program_outputs(sample)
        self.free_program()
        out = [("program", self.judge(sample, prog))]
        if faults:
            for name, plant in FAULTS.items():
                out.append((f"fault:{name}", self.judge(sample, plant(prog))))
        if control:
            out.append(("control", self.judge(sample, self.control_outputs(sample))))
        return out


TIE = 1e-2  # score units within which two best paths of other words tie


def _row_perturbed(outputs: list) -> list:
    """One transform row off by 1 % of the identity: the first sampled
    speaker's adapted features (both passes) with row 0 moved by 0.01 of
    the base feature's first dimension."""
    o = dict(outputs[0])
    for key in ("adapted1", "adapted2"):
        x = o[key].clone()
        x[..., 0] += 0.01 * o["base"][..., 0]
        o[key] = x
    return [o] + outputs[1:]


def _cost_altered(outputs: list) -> list:
    """One rescored arc's acoustic cost moved by 1."""
    o = dict(outputs[0])
    ft, arc, cost = o["rescored"][0]
    cost = np.array(cost, copy=True)
    cost[len(cost) // 2] += 1.0
    o["rescored"] = [(ft, arc, cost)] + o["rescored"][1:]
    return [o] + outputs[1:]


def _arc_dropped(outputs: list) -> list:
    """The SI lattice's arc at the first frame that holds one arc alone
    (an arc of the best path, the beam's width inside it) left out."""
    o = dict(outputs[0])
    ft, arc, cost = (np.asarray(a) for a in o["si"][0])
    frames, count = np.unique(ft, return_counts=True)
    lone = np.flatnonzero(ft == frames[np.argmax(count == 1)])[:1]
    keep = np.ones(len(ft), bool)
    keep[lone] = False
    o["si"] = [(ft[keep], arc[keep], cost[keep])] + o["si"][1:]
    return [o] + outputs[1:]


FAULTS = {"transform_row": _row_perturbed, "answer_altered": _cost_altered,
          "arc_dropped": _arc_dropped}

"""Realigning EM iterations through the program's training steps, one
after another over a whole training set held on the card.

An iteration is ``steps/train_tri.realign`` (span ``realign``: K2, then the
aligner, then ``apply_alignments``), ``e_step`` (span ``estep``) and
``m_step`` (span ``mstep``, mixing up to the configuration's Gaussian
count).  Set-up builds the model, the training graphs and the alignment set
once and runs the first iteration through the same call; the window goes on
from there.  The correctness comparison follows the last iteration completed
in the window from the same start (the model and transition
probabilities it began from, kept at its start) in float64: the alignment
against the best path of every sampled utterance's graph, the statistics of
the program's alignment, and the updated model and transition
probabilities.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import counts, judge, models
from .. import traffic as TR
from ..record import Compared
from ..reference import gmm as RG

KINDS = ("self", "next", "skip")


class Tree:
    """The transition model's view of a tree: each pdf belongs to one root,
    a (phone, HMM state) pair."""

    def __init__(self, num_pdfs: int, members: list, states_per_phone: int):
        self.num_pdfs = num_pdfs
        self.members = members  # root (phone - 1) * states_per_phone + state -> pdf ids
        self.spp = states_per_phone

    def possible_pdfs(self, phone: int, pdf_class: int) -> list:
        return list(self.members[(phone - 1) * self.spp + pdf_class])


def draw_roots(cfg: dict, gen, device) -> dict:
    """Each (phone, state) root gets one pdf, the rest of the pdfs go to
    roots at random; the pdfs' occupancy shares are log-normal.  Returns
    the roots' members and cumulative shares (padded), and each pdf's
    expected share of all frames."""
    m, topo = cfg["model"], cfg["topology"]
    p, spp = m["num_pdfs"], topo["states_per_phone"]
    r = topo["num_phones"] * spp
    root_of = torch.cat([torch.randperm(r, generator=gen, device=device),
                         torch.randint(0, r, (p - r,), generator=gen, device=device)])
    root_of = root_of.cpu().numpy()
    q = models.occupancy_shares(gen, p, m["occupancy_sigma"], device)
    members = [np.flatnonzero(root_of == i) for i in range(r)]
    k = max(len(x) for x in members)
    pad = np.full((r, k), -1, np.int64)
    cum = np.ones((r, k))
    occ = np.zeros(p)
    for i, mem in enumerate(members):
        share = q[mem] / q[mem].sum()
        pad[i, : len(mem)] = mem
        cum[i, : len(mem)] = np.cumsum(share)
        occ[mem] = share / r
    cum[:, -1] = 1.0
    return {"num_phones": topo["num_phones"], "members": pad, "cum_share": cum,
            "member_list": members, "occ": occ}


def tuple_ranks(members: list, spp: int, num_pdfs: int) -> np.ndarray:
    """Each pdf's rank among the (phone, HMM state, pdf) tuples in sorted
    order: its transition state is rank + 1, its transition ids
    ``1 + 3 rank + kind``."""
    keys = sorted((i // spp + 1, i % spp, int(pdf)) for i, mem in enumerate(members)
                  for pdf in mem)
    rank = np.zeros(num_pdfs, np.int64)
    for j, (_phone, _h, pdf) in enumerate(keys):
        rank[pdf] = j
    return rank


def topology(cfg: dict):
    from voicebridge_tpu_torch.models.topology import HmmTopology, TopologyState

    t = cfg["topology"]
    pr = [t["probs"][k] for k in KINDS]
    states = tuple(TopologyState(h, tuple((h + j, pr[j]) for j in range(3)))
                   for h in range(t["states_per_phone"])) + (TopologyState(-1, ()),)
    return HmmTopology({ph: states for ph in range(1, t["num_phones"] + 1)})


def arc_scores(cfg: dict) -> np.ndarray:
    """Graph scores of a self-loop, a next and a skip arc (float32)."""
    t, tr = cfg["topology"], cfg["train"]
    scale = (tr["self_loop_scale"], tr["transition_scale"], tr["transition_scale"])
    return np.array([s * math.log(t["probs"][k]) for s, k in zip(scale, KINDS)], np.float32)


def chain_graphs(corpus: dict, tid_base: np.ndarray, scores: np.ndarray) -> list:
    """Every utterance's training graph as the program's ``DenseGraph``: its
    states in a chain, the arc into state j carrying j's pdf, the
    transition id ``tid_base[j] + kind`` and its kind's score."""
    from voicebridge_tpu_torch.ops.graph import NEG_INF, DenseGraph

    ns = corpus["num_states"].astype(np.int64)
    first = np.cumsum(ns) - ns
    utt = np.repeat(np.arange(len(ns)), ns)
    pos = np.arange(len(utt)) - first[utt]
    pdf = corpus["state_pdf"]
    parts = [(0, np.ones(len(utt), bool), pos), (1, pos >= 1, pos - 1),
             (2, corpus["skip"], pos - 2)]
    a_utt = np.concatenate([utt[m] for _k, m, _s in parts])
    a_src = np.concatenate([s[m] for _k, m, s in parts])
    a_dst = np.concatenate([pos[m] for _k, m, _s in parts])
    kind = np.concatenate([np.full(int(m.sum()), k) for k, m, _s in parts])
    g = np.concatenate([np.flatnonzero(m) for _k, m, _s in parts])
    order = np.argsort(a_utt, kind="stable")
    a_utt, a_src, a_dst, kind, g = a_utt[order], a_src[order], a_dst[order], kind[order], g[order]
    a_pdf = pdf[g].astype(np.int32)
    a_tid = (tid_base[g] + kind).astype(np.int32)
    a_score = scores[kind]
    cuts = np.cumsum(np.bincount(a_utt, minlength=len(ns)))[:-1]
    graphs = []
    for s, src, dst, tid, pd, sc in zip(ns, *(np.split(x, cuts) for x in
                                              (a_src, a_dst, a_tid, a_pdf, a_score))):
        s = int(s)
        alpha0 = np.full(s, NEG_INF, np.float32)
        alpha0[0] = 0.0
        final = np.full(s, NEG_INF, np.float32)
        final[s - 1] = 0.0
        graphs.append(DenseGraph(
            num_states=s, arc_src=src.astype(np.int32), arc_dst=dst.astype(np.int32),
            arc_tid=tid, arc_pdf=pd, arc_score=sc, arc_oseq=np.zeros(len(src), np.int32),
            alpha0=alpha0, start_oseq=np.zeros(s, np.int32), final_score=final,
            final_oseq=np.zeros(s, np.int32), oseqs=[()]))
    return graphs


class Runner:
    def __init__(self, run):
        self.run = run
        self.cfg, self.spec = run.config, run.traffic

    def setup(self) -> None:
        from voicebridge_tpu_torch.config import TriTrainOptions
        from voicebridge_tpu_torch.models.transition import TransitionModel
        from voicebridge_tpu_torch.steps.align import AlignmentSet

        run, cfg, dev = self.run, self.cfg, self.run.device
        m, topo, tr = cfg["model"], cfg["topology"], cfg["train"]
        mark = time.perf_counter()
        gm = TR.generator(run.seed, dev, 2)
        self.roots = draw_roots(cfg, gm, dev)
        n = models.allot(self.roots["occ"], m["num_gauss"], tr["power"])
        centre = m["centre_scale"] * torch.randn((m["num_pdfs"], m["dim"]), generator=gm,
                                                 device=dev, dtype=torch.float64)
        self.true_gmm = models.draw_gmm(gm, dev, n, centre, m["spread"],
                                        torch.ones(m["dim"], device=dev, dtype=torch.float64),
                                        m["var_range"][0], m["var_range"][1], "dirichlet")
        self.gmm0 = models.perturbed(self.true_gmm, gm, dev, m["init_mean_step"],
                                     m["init_var_range"][0], m["init_var_range"][1])
        spec = {**self.spec, "num_utts": cfg["train_set"]["num_utts"],
                "states_per_phone": topo["states_per_phone"]}
        self.corpus = TR.kind(spec["kind"]).corpus(spec, self.true_gmm, self.roots,
                                                   TR.generator(run.seed, dev, 1), dev)
        feats = self.corpus["feats"]
        self.nf = self.corpus["num_frames"]
        run.phases["model and corpus"] = time.perf_counter() - mark
        mark = time.perf_counter()
        spp = topo["states_per_phone"]
        self.tree = Tree(m["num_pdfs"], self.roots["member_list"], spp)
        self.tm = TransitionModel(topology(cfg), self.tree)
        rank = tuple_ranks(self.roots["member_list"], spp, m["num_pdfs"])
        self.rank = rank
        graphs = chain_graphs(self.corpus, (1 + 3 * rank)[self.corpus["state_pdf"]],
                              arc_scores(cfg))
        self.names = [f"utt{i:05d}" for i in range(len(graphs))]
        self.aset = AlignmentSet(graphs, device=dev)
        self.graph_arcs = sum(g.num_arcs for g in graphs)
        run.phases["graphs and transition model"] = time.perf_counter() - mark
        mark = time.perf_counter()
        _ = self.aset.band_dev  # the band plan, built and moved to the card once
        run.phases["band plan"] = time.perf_counter() - mark
        mark = time.perf_counter()
        self.opts = TriTrainOptions(acoustic_scale=tr["acoustic_scale"],
                                    transition_scale=tr["transition_scale"],
                                    self_loop_scale=tr["self_loop_scale"], power=tr["power"],
                                    min_gaussian_occupancy=tr["min_gaussian_occupancy"],
                                    min_variance=tr["min_variance"])
        self.am = models.to_am(self.gmm0)
        self.feats = feats
        b, t, d = feats.shape
        self.x = feats.reshape(b * t, d)
        self.tids = np.zeros((b, t), np.int32)
        self.weights = np.zeros((b, t), np.float32)
        self.it = 0
        self.last: dict = {}
        for _ in range(int(self.spec["warmup_iterations"])):
            self.iteration(record=False)
        run.phases["first iterations"] = time.perf_counter() - mark

    def iteration(self, record: bool = True) -> None:
        from voicebridge_tpu_torch.steps import train_tri

        run, cfg = self.run, self.cfg
        self.it += 1
        # where this iteration starts, for the comparison if it is the last
        start = {"start_gmm": models.from_am(self.am), "start_log_probs": self.tm.log_probs.copy(),
                 "mix_seed": 1000 + self.it}
        with run.span("realign"):
            train_tri.realign(self.aset, self.am, self.feats, self.nf, self.tids, self.weights,
                              [], self.opts, "benchmark realign", self.names)
        with run.span("estep"):
            stats = train_tri.e_step(self.am, self.tm, self.x, self.tids, self.weights)
        self.last = {**start, "stats": [np.array(s, copy=True) for s in stats[:4]]}
        with run.span("mstep"):
            train_tri.m_step(self.am, self.tm, stats, cfg["model"]["num_gauss"], self.opts,
                             seed=start["mix_seed"])
        if not record:
            return
        frames = int(self.nf.sum())
        run.requests.append(("train", frames * 0.01, None))
        run.attempted += len(self.nf)
        run.failed += int((self.weights.sum(axis=1) == 0).sum())
        run.count("frames", frames)
        m = cfg["model"]
        run.add_work("acoustic_scoring", *counts.gmm(frames, m["num_gauss"], m["dim"],
                                                     m["num_pdfs"]))
        run.add_work("alignment", counts.banded_alignment(
            int((self.nf.astype(np.int64) * self.corpus["num_states"]).sum()),
            self.graph_arcs / max(int(self.corpus["num_states"].sum()), 1)))
        run.add_work("estep", counts.aligned_stats(frames, m["num_gauss"] / m["num_pdfs"],
                                                   m["dim"]))

    def window(self, deadline: float) -> None:
        while time.perf_counter() < deadline:
            self.iteration()

    # -- the correctness comparison ------------------------------------------

    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""
        self.aset = self.am = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self) -> dict:
        """The last iteration completed: where it started (``start_gmm``,
        ``start_log_probs``, ``mix_seed``) and what it produced (``tids``,
        ``weights``, ``stats``, the updated ``model`` and ``log_probs``)."""
        return {**self.last, "tids": self.tids, "weights": self.weights,
                "model": models.from_am(self.am), "log_probs": self.tm.log_probs.copy()}

    def check(self) -> None:
        it = self.outputs()
        self.free_program()
        self.run.compared = self.judge(it)

    def judge(self, it: dict) -> list:
        """The compared numbers of an iteration's outputs against the float64
        references from its start (``outputs``' keys)."""
        limits = self.run.cell["limits"]
        gap = self.alignment_gap(it["tids"], int(self.run.cell["check"]["utts"]),
                                 it["start_gmm"])
        stats_err, model_err = self.em_errors(it)
        return [Compared("ali_gap", gap, limits["ali_gap"]),
                Compared("stats_err", stats_err, limits["stats_err"]),
                Compared("model_err", model_err, limits["model_err"])]

    def sample(self, count: int) -> np.ndarray:
        """Utterances to judge, drawn from the seed, the longest among them."""
        gen = torch.Generator().manual_seed((int(self.run.seed) * 31 + 11) % (1 << 63))
        pick = torch.randperm(len(self.nf), generator=gen)[: max(count - 1, 0)].numpy()
        return np.unique(np.concatenate([pick, [int(np.argmax(self.nf))]]))

    def chains(self, utts: np.ndarray, gmm: dict, prec=None):
        """The reference's view of utterances' graphs and emissions:
        ``w [n, 3, S]`` arc scores, ``emit [n, T, S]`` the acoustic scale
        times each state's pdf's log-likelihood of each frame (under
        ``gmm``, in ``prec``), frame and state counts ``[n]``, and each
        state's pdf ``[n, S]``."""
        cfg, dev, c = self.cfg, self.run.device, self.corpus
        prec = prec or RG.EXACT
        ns = c["num_states"].astype(np.int64)
        first = np.cumsum(ns) - ns
        nf_u, ns_u = self.nf[utts].astype(np.int64), ns[utts]
        n, t_max, s_max = len(utts), int(nf_u.max()), int(ns_u.max())
        idx = first[utts][:, None] + np.arange(s_max)[None]
        valid = np.arange(s_max)[None] < ns_u[:, None]
        idx = np.where(valid, idx, 0)
        pdf = torch.as_tensor(np.where(valid, c["state_pdf"][idx], 0), device=dev).long()
        skip = torch.as_tensor(valid & c["skip"][idx], device=dev)
        validt = torch.as_tensor(valid, device=dev)
        sc = torch.as_tensor(arc_scores(cfg), device=dev, dtype=prec.dtype)
        neg = torch.full((n, s_max), -math.inf, dtype=prec.dtype, device=dev)
        first_state = torch.arange(s_max, device=dev)[None] >= 1
        w = torch.stack([torch.where(validt, sc[0], neg),
                         torch.where(validt & first_state, sc[1], neg),
                         torch.where(skip, sc[2], neg)], dim=1)
        scorer = RG.Scorer(gmm, dev, prec)
        acwt = float(cfg["train"]["acoustic_scale"])
        emit = torch.empty((n, t_max, s_max), dtype=prec.dtype, device=dev)
        step = 32
        for lo in range(0, n, step):
            u = torch.as_tensor(utts[lo:lo + step], device=dev)
            x = self.feats[u, :t_max].reshape(-1, self.feats.shape[2])
            ll = scorer.loglikes(x).view(len(u), t_max, -1)
            emit[lo:lo + step] = acwt * ll.gather(
                2, pdf[lo:lo + step, None, :].expand(len(u), t_max, s_max))
        return (w, emit, torch.as_tensor(nf_u, device=dev), torch.as_tensor(ns_u, device=dev),
                pdf)

    def alignment_gap(self, tids: np.ndarray, count: int, gmm: dict) -> float:
        """The worst sampled alignment's score below its graph's best path,
        in float64, under the model it was aligned with (inf for a path of
        wrong transition ids)."""
        dev = self.run.device
        utts = self.sample(count)
        worst = 0.0
        for lo in range(0, len(utts), 128):
            part = utts[lo:lo + 128]
            w, emit, nf, ns, pdf = self.chains(part, gmm)
            t_max = emit.shape[1]
            tid = torch.as_tensor(tids[part, :t_max].astype(np.int64), device=dev)
            kinds = (tid - 1) % 3
            live = torch.arange(t_max, device=dev)[None] < nf[:, None]
            state = torch.cumsum(torch.where(live, kinds, 0), 1).clamp_max(pdf.shape[1] - 1)
            base = torch.as_tensor(1 + 3 * self.rank, device=dev)[pdf.gather(1, state)]
            bad = ((tid != base + kinds) & live).any(dim=1)
            gap = judge.alignment_gap(w, emit, kinds, nf, ns)
            worst = max(worst, math.inf if bool(bad.any()) else gap)
        return worst

    def tids_of_kinds(self, utts: np.ndarray, kinds: torch.Tensor, nf: torch.Tensor,
                      pdf: torch.Tensor) -> np.ndarray:
        """Transition ids of paths given as arc kinds a frame."""
        dev = self.run.device
        live = torch.arange(kinds.shape[1], device=dev)[None] < nf[:, None]
        state = torch.cumsum(torch.where(live, kinds, 0), 1).clamp_max(pdf.shape[1] - 1)
        tid = torch.as_tensor(1 + 3 * self.rank, device=dev)[pdf.gather(1, state)] + kinds
        return torch.where(live, tid, 0).cpu().numpy()

    def em_errors(self, it: dict) -> tuple[float, float]:
        """(statistics error, model error) of an iteration, by the worst pdf,
        against float64 statistics of the program's alignment and the
        float64 update from them."""
        cfg, dev = self.cfg, self.run.device
        tr = cfg["train"]
        tids = it["tids"].reshape(-1).astype(np.int64)
        w = it["weights"].reshape(-1).astype(np.float64)
        pdf_of_rank = np.argsort(self.rank)
        pdf = pdf_of_rank[np.maximum(tids - 1, 0) // 3]
        gmm = it["start_gmm"]
        occ, sx, sxx, _total = RG.aligned_stats(gmm, self.x,
                                                torch.as_tensor(pdf, device=dev),
                                                torch.as_tensor(w, device=dev))
        n_tuples = len(self.rank)
        tcount = np.bincount(tids, weights=w, minlength=1 + 3 * n_tuples)
        g_occ, g_sx, g_sxx, g_t = it["stats"]
        stats_err = max(judge.leaf_error(g_occ, occ), judge.leaf_error(g_sx, sx),
                        judge.leaf_error(g_sxx, sxx),
                        judge.leaf_error(np.asarray(g_t)[1:].reshape(n_tuples, 3),
                                         tcount[1:].reshape(n_tuples, 3)))
        model = RG.mle_update(gmm, occ, sx, sxx, tr["min_gaussian_occupancy"],
                              tr["min_variance"])
        model = RG.mix_up(model, cfg["model"]["num_gauss"], occ, tr["power"], seed=it["mix_seed"])
        starts = 1 + 3 * np.arange(n_tuples + 1)
        lp = RG.transition_update(it["start_log_probs"], starts, tcount)
        got = it["model"]
        mm = max(got["means"].shape[1], model["means"].shape[1])

        def pad(a, fill):
            extra = mm - a.shape[1]
            if extra <= 0:
                return a
            shape = (a.shape[0], extra) + a.shape[2:]
            return np.concatenate([a, np.full(shape, fill)], axis=1)

        model_err = max(judge.leaf_error(pad(got["means"], 0.0), pad(model["means"], 0.0)),
                        judge.leaf_error(pad(got["vars"], 1.0), pad(model["vars"], 1.0)),
                        judge.leaf_error(pad(got["weights"], 0.0), pad(model["weights"], 0.0)),
                        judge.leaf_error(np.exp(it["log_probs"][1:]).reshape(n_tuples, 3),
                                         np.exp(lp[1:]).reshape(n_tuples, 3)))
        return stats_err, model_err

"""EM iterations over fixed alignments through the program's training
steps (``train_lda_mllt.sh`` on the 28 of its 35 iterations that neither
realign nor update the MLLT matrix; those 4 MLLT iterations are in neither
training cell): set-up aligns the training set once (``steps/train_tri.realign``,
span ``realign``); an iteration is ``e_step`` (span ``estep``: K6 over the
fixed alignment) and ``m_step`` (span ``mstep``).  Everything else is
``train_realign``'s: the model, the corpus, the graphs and the comparison,
which holds set-up's alignment to the best paths under the model it was made
with, and the last iteration's statistics and update to float64 ones from
its start.
"""

from __future__ import annotations

import numpy as np

from .. import counts, models
from ..record import Compared
from . import train_realign


class Runner(train_realign.Runner):
    def setup(self) -> None:
        self.aligned = None  # the model set-up aligned with
        super().setup()

    def iteration(self, record: bool = True) -> None:
        from voicebridge_tpu_torch.steps import train_tri

        run, cfg = self.run, self.cfg
        self.it += 1
        start = {"start_gmm": models.from_am(self.am), "start_log_probs": self.tm.log_probs.copy(),
                 "mix_seed": 1000 + self.it}
        if self.aligned is None:
            with run.span("realign"):
                train_tri.realign(self.aset, self.am, self.feats, self.nf, self.tids,
                                  self.weights, [], self.opts, "benchmark align", self.names)
            self.aligned = start["start_gmm"]
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
        run.add_work("estep", counts.aligned_stats(frames, m["num_gauss"] / m["num_pdfs"],
                                                   m["dim"]))

    def outputs(self) -> dict:
        return {**super().outputs(), "aligned_gmm": self.aligned}

    def judge(self, it: dict) -> list:
        """The compared numbers: set-up's alignment under the model it was
        made with, and the last iteration's statistics and update from its
        start."""
        limits = self.run.cell["limits"]
        gap = self.alignment_gap(it["tids"], int(self.run.cell["check"]["utts"]),
                                 it["aligned_gmm"])
        stats_err, model_err = self.em_errors(it)
        return [Compared("ali_gap", gap, limits["ali_gap"]),
                Compared("stats_err", stats_err, limits["stats_err"]),
                Compared("model_err", model_err, limits["model_err"])]

    def readings(self, control: bool = False, faults: bool = False) -> list:
        """[(reading, [Compared])] after the window: the program's, with
        ``control`` the TF32 references' iteration from the last one's
        start, with ``faults`` each of ``readings.iteration_faults``'."""
        from readings import iteration_faults

        from .. import control as C

        it = self.outputs()
        planted = iteration_faults(self, it) if faults else {}
        self.free_program()
        out = [("program", self.judge(it))]
        out += [(f"fault:{name}", self.judge(o)) for name, o in planted.items()]
        if control:
            out.append(("control", self.judge(C.train_iteration(self, it))))
        return out

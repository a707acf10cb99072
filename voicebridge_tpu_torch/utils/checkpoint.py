"""Training checkpoint/resume.

Counterpart of the reference's numbered per-iteration artifacts
(``0.mdl .. 40.mdl``, ``x.occs``, per-job alignments; SURVEY.md §5.4) —
re-designed as a single atomic checkpoint directory per EM iteration holding
the model arrays, transition probabilities, alignment state, and counters.
Sharding-agnostic by construction: GMM state is host-resident numpy between
iterations, so a checkpoint restores on any mesh shape.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np

from ..models.gmm import AmDiagGmm


class TrainCheckpoint:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.keep = keep

    def save(self, iteration: int, am: AmDiagGmm, trans_log_probs: np.ndarray,
             tids: np.ndarray, weights: np.ndarray, extra: dict | None = None
             ) -> Path:
        """Atomic write of iteration state (write to temp dir then rename)."""
        self.dir.mkdir(parents=True, exist_ok=True)
        final = self.dir / f"iter_{iteration:04d}"
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_ckpt_"))
        try:
            am.save(tmp / "am.npz")
            np.savez_compressed(tmp / "state.npz",
                                trans_log_probs=trans_log_probs,
                                tids=tids, weights=weights)
            meta = {"iteration": iteration, "num_gauss": am.num_gauss}
            meta.update(extra or {})
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        ckpts = sorted(self.dir.glob("iter_*"))
        for old in ckpts[: max(len(ckpts) - self.keep, 0)]:
            shutil.rmtree(old, ignore_errors=True)

    def latest(self) -> dict | None:
        """Load the most recent checkpoint or None."""
        ckpts = sorted(self.dir.glob("iter_*"))
        if not ckpts:
            return None
        path = ckpts[-1]
        meta = json.loads((path / "meta.json").read_text())
        state = np.load(path / "state.npz")
        return {
            "iteration": meta["iteration"],
            "meta": meta,
            "am": AmDiagGmm.load(path / "am.npz"),
            "trans_log_probs": state["trans_log_probs"],
            "tids": state["tids"],
            "weights": state["weights"],
        }

"""The control of the correctness comparison: the plain references put in
the program's place and computed in TF32 (``reference.precision.TF32``),
the precision one step below the configurations' IEEE float32.  Each
function returns what the program's outputs are judged as, so the same
judge reads the control: a comparison that passes the control is too loose.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import align as RA
from .reference import frontend as RF
from .reference import gmm as RG
from .reference import lattice as RL
from .reference.precision import TF32


def decode_outputs(runner, sample: list, block: int = 16) -> list:
    """The sampled requests' features and lattices, from TF32 features,
    TF32 log-likelihoods and a float32 forward-backward."""
    dev, graph = runner.run.device, runner.graph
    d = runner.cfg["decode"]
    pdf = torch.as_tensor(graph["pdf"], device=dev).long()
    scorer = RG.Scorer(runner.gmm, dev, TF32)
    out = []
    for k, utts in sample:
        waves, _utt2spk, ids = runner.pool[k]
        feats = RF.features(runner.stack(waves), ids, runner.feat, TF32)
        lats = {}
        for lo in range(0, len(utts), block):
            part = utts[lo:lo + block]
            ll = torch.stack([scorer.loglikes(feats[i]) for i in part])
            found = {i: [] for i in range(len(part))}

            def visit(t, margin, found=found):
                lane, arc = torch.nonzero(margin >= 0, as_tuple=True)
                for i in range(len(part)):
                    a = arc[lane == i]
                    found[i].append((torch.full_like(a, t), a))

            RL.forward_backward(graph, ll, float(d["acoustic_scale"]), float(d["lattice_beam"]),
                                prec=TF32, visit=visit)
            for i, u in enumerate(part):
                ft = torch.cat([x for x, _ in found[i]])
                arc = torch.cat([a for _, a in found[i]])
                cost = -ll[i, ft, pdf[arc]]
                lats[u] = (ft.cpu().numpy(), arc.cpu().numpy(), cost.cpu().numpy())
        out.append((feats, lats))
    return out


def train_iteration(runner, it: dict, block: int = 256) -> dict:
    """An EM iteration by the references in TF32 from where the program's
    iteration ``it`` started: every utterance's best path under TF32
    log-likelihoods, TF32 statistics of it, and the update from them."""
    dev, cfg = runner.run.device, runner.cfg
    tr, m = cfg["train"], cfg["model"]
    nf = runner.nf
    b, t_all = nf.shape[0], runner.feats.shape[1]
    tids = np.zeros((b, t_all), np.int64)
    order = np.argsort(-nf, kind="stable")
    for lo in range(0, b, block):
        part = order[lo:lo + block]
        w, emit, nf_p, ns_p, pdf = runner.chains(part, it["start_gmm"], TF32)
        kinds = RA.best_paths(w, emit, nf_p, ns_p)
        tids[part, : emit.shape[1]] = runner.tids_of_kinds(part, kinds, nf_p, pdf)
        del w, emit
    weights = (np.arange(t_all)[None] < nf[:, None]).astype(np.float32)
    flat = tids.reshape(-1)
    pdf_of_rank = np.argsort(runner.rank)
    frame_pdf = torch.as_tensor(pdf_of_rank[np.maximum(flat - 1, 0) // 3], device=dev)
    gmm = it["start_gmm"]
    occ, sx, sxx, _total = RG.aligned_stats(gmm, runner.x, frame_pdf,
                                            torch.as_tensor(weights.reshape(-1), device=dev),
                                            TF32)
    n_tuples = len(runner.rank)
    tcount = np.bincount(flat, weights=weights.reshape(-1), minlength=1 + 3 * n_tuples)
    model = RG.mle_update(gmm, occ, sx, sxx, tr["min_gaussian_occupancy"],
                          tr["min_variance"])
    model = RG.mix_up(model, m["num_gauss"], occ, tr["power"], seed=it["mix_seed"])
    lp = RG.transition_update(it["start_log_probs"], 1 + 3 * np.arange(n_tuples + 1), tcount)
    return {**it, "tids": tids.astype(np.int32), "weights": weights,
            "stats": [occ, sx, sxx, tcount], "model": model, "log_probs": lp}

"""Time K4 (banded alignment forward and backtrace), K6 (aligned E-step
statistics) and the generic aligner (forward and backtrace) of one checkout
of voicebridge_tpu_torch on one NVIDIA GPU, at the shapes of
``chip_smoke.py`` phases 3, 15 and 16, so that two checkouts compare in one
call.

    python tools/time_training_kernels.py [--tree DIR] [--label NAME] [--reps N]

``--tree`` is the root of the checkout to time (default: this one): its
``voicebridge_tpu_torch`` is imported and its kernels built into its own
``_build``; the inputs and the timing come from this checkout's
``chip_smoke.py``, so both trees get the same work.  To compare with the
parent commit, unpack it under ``_archive/`` (``git archive``) and run the
two in turns in one call: parent, change, change, parent.

Shapes: K4 at phase 3's (192 utterances x 400 frames, 384-state training
graphs, 2000 pdfs; phases 15 and 16 align at the same shape), its backtrace
also for one utterance alone; K6 on the
pdfs of that alignment (76,800 frames) at phase 3's model (2000 x 5 x 39,
one feature array), at D = 40 with 1-8 Gaussians a pdf (phase 15's uneven
mixtures, drawn here) and at D = 40 with two feature arrays (phase 16's
``alimdl`` path); the generic aligner at phase 3's shape over graphs with
two back arcs each, as ``align_feats`` calls it, also its forward for one
utterance a streaming multiprocessor and both for one utterance alone (a
checkout whose ``ops/viterbi.py`` has no ``generic_forward`` is called
through the padded arrays, its CSR built per call).  Another version of a
kernel source is timed by ``--tree`` on a copy of the checkout with that
source in its ``csrc/`` (``tools/kernel_variants/``).  Prints one JSON
object: the card's name and power limit, and per kernel and shape the time
through the wrapper (CUDA events, mean of
``--reps`` calls after a warm-up), the host's time to issue a call (the
wrapper's own cost: ``--reps`` calls without a synchronisation), the device
time alone and the device activities a call (torch.profiler over ``--reps``
calls).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def uneven_am(num_pdfs: int, max_mix: int, dim: int, seed: int):
    """A GMM with 1 .. max_mix active Gaussians a pdf."""
    import numpy as np

    from voicebridge_tpu_torch.models.gmm import AmDiagGmm

    rng = np.random.default_rng(seed)
    inv_vars = np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32) + 0.3
    means = rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32)
    weights = rng.random((num_pdfs, max_mix)).astype(np.float32)
    live = rng.integers(1, max_mix + 1, num_pdfs)
    weights[np.arange(max_mix)[None, :] >= live[:, None]] = 0.0
    weights /= weights.sum(axis=1, keepdims=True)
    return AmDiagGmm(means * inv_vars, inv_vars, weights)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "tests")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_training_kernels: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke_helpers", ROOT / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = C  # its dataclasses look their module up
    spec.loader.exec_module(C)
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import gmm_kernel, gmm_kernels, gmm_stats_kernel
    from voicebridge_tpu_torch.ops import viterbi as V
    from voicebridge_tpu_torch.testing import random_am

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    _build.library()
    width = C.FULL
    report = {"card": card, "tree": str(tree), "label": args.label}

    def timed(name, fn):
        report[name] = {"wrapper_ms": C.cuda_ms(torch, fn, args.reps),
                        **C.device_profile(torch, fn, args.reps)}

    graphs, aset, feats, nf_np = C.train_shape(width, device)
    plan = aset.band_dev
    nf = torch.from_numpy(nf_np).to(device)
    w39 = gmm_kernels.pack_gmm(random_am(width.num_pdfs, width.max_mix, 39), device)
    ll = gmm_kernel.loglikes_batch(feats, w39)
    # the parent's wrapper takes no host pdf range
    extra = (plan.pdf_range,) if hasattr(plan, "pdf_range") else ()
    fwd = (plan.W, plan.pdf, plan.alpha0, ll, nf, 0.1, plan.offsets, *extra)
    alpha_end, bps = AB.viterbi_forward_banded(*fwd)
    timed("align_forward", lambda: AB.viterbi_forward_banded(*fwd))
    bt = (alpha_end, plan.final, bps, nf, plan.offsets, plan.arc_of)
    arcs = AB.backtrace_banded(*bt)[0].cpu().numpy()
    timed("align_backtrace", lambda: AB.backtrace_banded(*bt))
    one = (alpha_end[:1], plan.final[:1], bps[:, :1].contiguous(), nf[:1], plan.offsets,
           plan.arc_of[:1])
    timed("align_backtrace_one_utt", lambda: AB.backtrace_banded(*one))
    del ll, bps
    n = feats.shape[0] * feats.shape[1]
    rng = np.random.default_rng(15)
    x40 = torch.from_numpy(rng.standard_normal((n, 40), dtype=np.float32)).to(device)
    x40b = torch.from_numpy(rng.standard_normal((n, 40), dtype=np.float32)).to(device)
    w40 = gmm_kernels.pack_gmm(uneven_am(width.num_pdfs, 8, 40, seed=15), device)
    x39 = feats.reshape(n, feats.shape[2])
    for name, w, x_post, x_acc in (("gmm_stats_phase3", w39, x39, x39),
                                   ("gmm_stats_d40_uneven", w40, x40, x40),
                                   ("gmm_stats_d40_twofeats", w40, x40, x40b)):
        k6 = C.k6_inputs(torch, device, graphs, arcs, x_post, x_acc)
        timed(name, lambda: gmm_stats_kernel.acc_stats(w, *k6, width.num_pdfs))
    del k6, x40, x40b
    _, g_aset, g_feats, g_nf_np = C.train_shape(width, device, width.back_arcs)
    g_nf = torch.from_numpy(g_nf_np).to(device)
    g_ll = gmm_kernel.loglikes_batch(g_feats, w39)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sizes = (("", g_nf.shape[0]), ("_one_per_sm", sms), ("_one_utt", 1))
    for suffix, n in sizes:  # all utterances, one a SM, one alone
        idx = np.arange(n)
        ll_i, nf_i = g_ll[:n].contiguous(), g_nf[:n].contiguous()
        if hasattr(V, "generic_forward"):  # the set's plan, built once
            plan = g_aset.generic_dev.take(idx)
            fwd = (plan, ll_i, nf_i, 0.1, 1e9)
            ae, bps, codes = V.generic_forward(*fwd)
            timed("generic_forward" + suffix, lambda: V.generic_forward(*fwd))
            bt = (plan, ae, bps, codes, nf_i)
            backtrace = lambda: V.generic_backtrace(*bt)  # noqa: E731
        else:  # the padded arrays, the CSR built per call
            p = {k: v[idx] if isinstance(v, np.ndarray) else v for k, v in g_aset.padded.items()}
            fwd = (p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"], p["alpha0"], ll_i,
                   g_nf_np[idx], 0.1, 1e9, p["num_states"])
            ae, bps = V.viterbi_forward_batched(*fwd)
            timed("generic_forward" + suffix, lambda: V.viterbi_forward_batched(*fwd))
            bt = (p["arc_src"], ae, p["final_score"], bps, g_nf_np[idx])
            backtrace = lambda: V.backtrace_batched_device(*bt)  # noqa: E731
        if suffix != "_one_per_sm":
            timed("generic_backtrace" + suffix, backtrace)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 20 of ``chip_smoke.py`` alone at full width, on the card: phase 9's
graph, GMM, features and exact best-path scores rebuilt (about 5 s), then
``tf32_guard`` (with a random stand-in for phase 15's LDA matrix),
``parallel_full_width`` and ``lane_fb_full_width``.  Prints each part's
facts and seconds, and the lane-major FB's kernels entry.

    python tools/smoke_phase20.py      # from the repo root, on a machine with the card

It spawns the world-size-2 ranks, so its work stays under the ``__main__``
check.
"""
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "tests")]
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def lane_inputs(device, width) -> dict:
    """Phase 9's inputs, as ``chip_smoke.lattice_full_width`` builds them:
    its decoder (graph, GMM on the features' scale), padded features, frame
    counts and the exact best paths' scores rescored in float64."""
    from voicebridge_tpu_torch import DecodeOptions, FrameOptions, MelOptions, MfccOptions
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.steps.decode import Decoder
    from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
    from voicebridge_tpu_torch.testing import feature_scaled_am, synth_decode_graph

    waves = C.synth_waves(width, seed=3)
    utt2spk = {u: f"spk{i % 8}" for i, u in enumerate(sorted(waves))}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=width.samp_freq, dither=1.0),
                       mel_opts=MelOptions(num_bins=23))
    feats = make_features(waves, utt2spk, opts, device=device)
    x = torch.cat(list(feats.values())).double()
    am = feature_scaled_am(x.mean(0).cpu().numpy(), x.var(0).cpu().numpy() / 30.0,
                           width.num_pdfs, width.max_mix)
    dec = Decoder.from_dense_graph(synth_decode_graph(width.num_states, num_pdfs=width.num_pdfs),
                                   am, DecodeOptions(acoustic_scale=1.0 / 13.0), device=device,
                                   row_width=8)
    batch, nf = pad_features(feats, sorted(feats))
    g, acwt = dec.graph, 1.0 / 13.0
    ll = dec._loglikes(batch.contiguous())
    paths = DC.decode_best_path(g, dec.plan, dec.plan_dev, ll, np.asarray(nf.cpu()), acwt)
    arcs = np.stack([p["arcs"] for p in paths])
    pdf = torch.from_numpy(g.arc_pdf[arcs]).long().to(device)
    amsc = ll.gather(2, pdf[:, :, None])[..., 0].double().sum(dim=1).cpu().numpy()
    exact = (g.alpha0[g.arc_src[arcs[:, 0]]].astype(np.float64)
             + g.arc_score[arcs].astype(np.float64).sum(axis=1) + acwt * amsc)
    return {"dec": dec, "batch": batch, "nf": np.asarray(nf.cpu(), np.int32), "exact": exact}


def timed(what: str, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"{what}: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def main() -> int:
    from voicebridge_tpu_torch import _build

    if not torch.cuda.is_available():
        print("smoke_phase20: CUDA is not available", file=sys.stderr)
        return 1
    device, width = torch.device("cuda", 0), C.FULL
    timed("build", _build.library)
    lane = timed("phase 9's inputs", lambda: lane_inputs(device, width))
    final_mat = np.random.default_rng(0).standard_normal((40, 92)).astype(np.float32) * 0.1
    t20 = time.perf_counter()
    arrays = timed("arrays", lambda: C.phase20_arrays(torch, device, width))
    timed("TF32 guard", lambda: C.tf32_guard(torch, device, lane, final_mat, arrays, print))
    timed("parallel", lambda: C.parallel_full_width(torch, device, width, arrays, lane, print))
    kernels: dict = {}
    timed("lane-major FB", lambda: C.lane_fb_full_width(torch, device, width, lane, kernels,
                                                        print))
    print(f"phase 20: {time.perf_counter() - t20:.2f} s")
    print(json.dumps(kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())

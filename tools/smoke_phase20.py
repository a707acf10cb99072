"""Phase 20 of ``chip_smoke.py`` alone at full width, on the card: phase 9's
graph, GMM, features and exact best-path scores rebuilt (about 5 s), then
``tf32_guard`` (with a random stand-in for phase 15's LDA matrix),
``parallel_full_width`` and ``lane_fb_full_width``.  Prints each part's
facts and seconds, and the lane-major FB's kernels entry.

    python tools/smoke_phase20.py      # from the repo root, on a machine with the card
    python tools/smoke_phase20.py --lane-only [--tree DIR] [--label NAME] [--reps 3]
                                  [--variant NAME=DIR ...] [--hub]

``--lane-only`` times only the lane-major lattice FB
(``lattice_forward_backward_packed``) on phase 9's inputs, all 128 lanes, at
exact search and at beam 13 / ``max_active`` 2000 (CUDA events, mean of
``--reps`` after a warm-up), with the device time by kernel and the device
activities of one call under torch.profiler and a checksum of the packed
survivors; ``--tree`` imports ``chip_smoke`` and the package (and so its
kernel sources and wrappers) from another checkout, e.g. the parent commit
unpacked under ``_archive/`` with ``git archive``.  Run the two trees in
turns in one call (parent, change, change, parent) and compare their JSON
lines; the checksums must agree.  Each ``--variant`` names a directory with
another ``lattice_lane.cu`` of the same C interface, built by
``tools/time_viterbi_kernels.py``'s ``build`` and timed through the tree's
wrapper in turns with the tree's own (all in order, then in reverse).
``--hub`` also times the FB, exact search, on ``synth_hub_graph(60000,
5000, 2000)`` and on the same graph without the hub (``hub_arcs`` 0),
random log-likelihoods, 128 lanes x 256 frames: the difference is what a
hub of 5,000 in- and 5,000 out-arcs costs.

It spawns the world-size-2 ranks, so its work stays under the ``__main__``
check.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

C = None  # the tree's chip_smoke (``main``)


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


def packed_stats(bits) -> dict:
    """A checksum of packed survivors (equal between trees that agree) and
    their count, 16 frames at a time on the device."""
    weights = torch.arange(bits.shape[-1], device=bits.device, dtype=torch.int64) % 251 + 1
    ones = torch.tensor([bin(i).count("1") for i in range(256)], device=bits.device)
    frames = range(0, bits.shape[0], 16)
    return {"checksum": sum(int((bits[lo:lo + 16].long() * weights).sum()) for lo in frames),
            "survivors": sum(int(ones[bits[lo:lo + 16].long()].sum()) for lo in frames)}


def phase_split(fn, windows: int) -> dict:
    """Device ms of one call's lane-major kernels under torch.profiler, by
    phase: the forward of phase 1 (the first ``windows`` forward launches),
    the recomputing forward and the backward of phase 2 (kernels of
    ``lattice_lane.cu`` that run one launch per window and pass)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                 and ("lane_forward_kernel" in e.name or "lane_backward_kernel" in e.name)),
                key=lambda e: e.time_range.start)
    fwd = [(e.time_range.end - e.time_range.start) / 1e3 for e in ev
           if "lane_forward_kernel" in e.name]
    bwd = [(e.time_range.end - e.time_range.start) / 1e3 for e in ev
           if "lane_backward_kernel" in e.name]
    if len(fwd) != 2 * windows or len(bwd) != windows:
        return {}
    return {"phase1_forward_ms": sum(fwd[:windows]), "phase2_forward_ms": sum(fwd[windows:]),
            "phase2_backward_ms": sum(bwd)}


def lane_times(device, plan, ll, nf, reps: int) -> dict:
    """The lane-major FB at phase 9's shape (``plan``, log-likelihoods
    ``ll``), exact search and beam 13 / max_active 2000: ms per call,
    device time by kernel and activities of one call, its kernels' device
    time by phase, launches, and the packed survivors' checksum and count."""
    from voicebridge_tpu_torch import _build
    from voicebridge_tpu_torch.ops import lattice as LAT

    out = {}
    windows = -(-ll.shape[1] // C.LANE_WINDOW)
    for name, (beam, max_active) in (("exact", (1e9, 0)), ("beam13_ma2000", (13.0, 2000))):
        def fn():
            return LAT.lattice_forward_backward_packed(plan, ll, nf, 1.0 / 13.0, beam, 6.0,
                                                       max_active, C.LANE_WINDOW)

        C.reset_launches()
        bits, best = fn()[:2]
        torch.cuda.synchronize()
        launches = _build.launches["lattice_lane"]
        stats = packed_stats(bits)
        best_sum = float(best.double().sum())
        del bits, best
        prof = C.device_profile(torch, fn, calls=1)
        out[name] = {"ms": C.cuda_ms(torch, fn, reps), "launches": launches,
                     "device_ms": prof["device_ms"],
                     "device_activities": prof["activities_per_call"],
                     "device_ms_by_name": prof["device_ms_by_name"],
                     **phase_split(fn, windows), **stats, "total_best_sum": best_sum}
    return out


def hub_times(device, reps: int) -> dict:
    """ms per call of the exact-search FB over a graph with and without a
    hub of 5,000 in- and out-arcs (128 lanes x 256 frames), with the packed
    survivors' count and device time by kernel."""
    from voicebridge_tpu_torch.ops import lattice as LAT
    from voicebridge_tpu_torch.testing import synth_hub_graph

    ll = torch.from_numpy((np.random.default_rng(0).standard_normal((128, 256, 2000)) * 5
                           - 60).astype(np.float32)).to(device)
    out = {}
    for name, hub in (("no_hub", 0), ("hub_5000", 5000)):
        g = synth_hub_graph(60_000, hub, num_pdfs=2000)
        plan = LAT.lane_plan_to_device(g, LAT.build_dst_plan(g), LAT.build_src_plan(g), device)

        def fn():
            return LAT.lattice_forward_backward_packed(plan, ll, np.full(128, 256, np.int32),
                                                       1.0 / 13.0, 1e9, 6.0, 0, C.LANE_WINDOW)

        stats = packed_stats(fn()[0])
        prof = C.device_profile(torch, fn, calls=1)
        out[name] = {"ms": C.cuda_ms(torch, fn, reps), "survivors": stats["survivors"],
                     "device_ms_by_name": {k: v for k, v in prof["device_ms_by_name"].items()
                                           if "lane_" in k}}
    return out


def lane_ptxas(report: str) -> list:
    """(kernel, registers, spill stores) of the lane-major kernels in an
    ``nvcc -Xptxas=-v`` report."""
    out, name = [], None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "lane_" in line else None
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            out.append((name[-40:], int(line.split("Used")[1].split()[0]), spill))
            name = None
    return out


def main() -> int:
    global C
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane-only", action="store_true")
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default="change")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--hub", action="store_true")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(tree / "tests")]
    import chip_smoke
    from voicebridge_tpu_torch import _build

    C = chip_smoke
    if not torch.cuda.is_available():
        print("smoke_phase20: CUDA is not available", file=sys.stderr)
        return 1
    device, width = torch.device("cuda", 0), C.FULL
    timed("build", _build.library)
    lane = timed("phase 9's inputs", lambda: lane_inputs(device, width))
    if args.lane_only:
        import time_viterbi_kernels as TV
        from voicebridge_tpu_torch.ops import lattice as LAT

        g = lane["dec"].graph
        plan = LAT.lane_plan_to_device(g, LAT.build_dst_plan(g), LAT.build_src_plan(g), device)
        ll = lane["dec"]._loglikes(lane["batch"].contiguous())  # K2, the tree's own library
        TV._build = _build
        libs = {args.label: _build.library()}
        for n, d in (v.split("=", 1) for v in args.variant):
            libs[n], report = TV.build(n, Path(d))
            print(json.dumps({"variant": n, "ptxas": lane_ptxas(report)}), flush=True)
        for order in (list(libs), list(libs)[::-1]) if args.variant else (list(libs),):
            for name in order:
                _build._lib = libs[name]
                res = lane_times(device, plan, ll, lane["nf"], args.reps)
                if args.hub:
                    res["hub"] = hub_times(device, args.reps)
                print(json.dumps({"label": name, "tree": str(tree),
                                  "card": torch.cuda.get_device_name(0), **res}), flush=True)
        return 0
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

"""Time the Viterbi relaxation (K3), the lattice recompute-and-test step (K5),
the N-best relaxation (K7), the best-path backtrace (``backtrace_best``) and
the N-best walk (``backtrace_nbest``) of voicebridge_tpu_torch at full width
on one NVIDIA GPU, for the checkout's kernel sources and for other versions
of them side by side.

    python tools/time_viterbi_kernels.py [--lanes 128] [--frames 16]
                                         [--cases all|nbest]
                                         [--variant NAME=DIR ...]
                                         [--tree DIR] [--label NAME]

The full-width decode graph (60k states, 480k arcs, forward plan D = 8, the
backward plan's D derived, 2) and random inputs from numpy seeds.  Cases, in
ms per frame (CUDA events, mean of 5 runs after a warm-up): K3 over the
forward plan as one window of ``--frames`` frames with and without
backpointers and one frame a launch; K3 over the backward plan (the lattice's
``bwd_window``, beta_eff select fused) as a window and one frame a launch;
K5 as a window and one frame a launch; K7 at the full-width N-best shape (32
lanes x 4 slots, exact search, every slot live as late in an utterance) as a
window and one frame a launch; ``backtrace_best`` for all ``--lanes`` lanes
and for one lane alone (ms per call, as the decode launches it once a
block) over a 1000-frame table that K3 wrote, as the smoke times it (the
same walk repeated: the table's lines it reads stay in L2) and with the L2
cache flushed before each run and the plan's arrays read back into it (as
the decode finds it after K3).  ``--cases nbest`` times only the N-best
walk at the full-width N-best decode's shape: K7's tables over 1000 frames
of 32 lanes x 4 slots at exact search (38 GB), walked from each lane's 16
best end entries as ``backtrace_nbest_device`` takes them, all walks and
one walk alone, in L2 and flushed (``backtrace_nbest*``, ms per call), and
``backtrace_nbest_device`` itself (wall ms per call, device time and
activities under torch.profiler; with the decoder's plan where the
checkout's wrapper takes one).  Each ``--variant`` names a directory
holding other versions of ``viterbi_step.cu``, ``lattice_fb.cu``,
``viterbi_nbest.cu``, ``backtrace.cu`` and/or ``lattice_lane.cu`` (same C
interface; ``tools/smoke_phase20.py --lane-only`` times the last), or the
thread-per-walk N-best walk's ``vbt_backtrace_nbest_thread`` of
``tools/kernel_variants/backtrace_nbest_thread``); every version is built
with the package's nvcc flags into its own library under
``_archive/kernel_variants/`` and timed in turns (all in order, then in
reverse).  ``--tree`` imports the package (and its kernel sources) from
another checkout, e.g. the parent commit unpacked under ``_archive/`` with
``git archive``, so that the parent's wrapper is timed too: run the two
trees in turns in one call.  Prints one JSON object with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

import numpy as np
import torch

_build = DC = LAT = V = synth_decode_graph = C = None  # the tree's modules (``load``)


def load(tree: Path) -> None:
    """Import the package (and its chip_smoke) from ``tree``."""
    global _build, DC, LAT, V, synth_decode_graph, C
    sys.path[:0] = [str(tree), str(tree / "tests")]
    import chip_smoke
    from voicebridge_tpu_torch import _build as build_mod
    from voicebridge_tpu_torch.ops import decode_core, lattice, viterbi
    from voicebridge_tpu_torch.testing import synth_decode_graph as graph_fn

    _build, DC, LAT, V, synth_decode_graph, C = (build_mod, decode_core, lattice, viterbi,
                                                 graph_fn, chip_smoke)


OUT = ROOT / "_archive" / "kernel_variants"
KERNEL_SOURCES = ("viterbi_step.cu", "lattice_fb.cu", "viterbi_nbest.cu", "backtrace.cu",
                  "lattice_lane.cu")
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# bp_arc, bp_slot, stride t, b, s, k, arc_src, num_frames, state, slot, b,
# c, t, arcs, state_out, ok, stream
THREAD_WALK_SIGNATURE = (_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                         _P)


def build(name: str, src_dir: Path | None) -> tuple[ctypes.CDLL, str]:
    """Build mfcc.cu (the error strings) with the kernel sources from
    ``src_dir`` (default: the package's) into one library; returns it and
    the compiler's register report."""
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for src in ("mfcc.cu",) + KERNEL_SOURCES:
        path = src_dir / src if src_dir is not None and (src_dir / src).exists() else \
            _build.CSRC / src
        obj = out / f"{src}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj), str(path)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    report = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"{name}: nvcc failed\n{report}")
    lib_path = out / "libvariant.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("vbt_viterbi_step", "vbt_lattice_fb", "vbt_viterbi_nbest", "vbt_backtrace_best",
               "vbt_backtrace_nbest", "vbt_lattice_lane_forward", "vbt_lattice_lane_backward"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    if hasattr(lib, "vbt_backtrace_nbest_thread"):
        lib.vbt_backtrace_nbest_thread.argtypes = THREAD_WALK_SIGNATURE
        lib.vbt_backtrace_nbest_thread.restype = ctypes.c_int
    lib.vbt_error_string.argtypes = (ctypes.c_int,)
    lib.vbt_error_string.restype = ctypes.c_char_p
    return lib, report


def ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ms_cold(fn, warm: tuple, reps: int = 5) -> float:
    """``ms`` with the L2 cache flushed before each run (a 256 MB write) and
    then only ``warm`` read back into it, as the decode's backtrace finds the
    cache after K3: the plan's arrays hot, the backpointer table cold."""
    flush = torch.empty(1 << 26, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        for x in warm:
            x.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def cases(lanes: int, frames: int) -> tuple:
    dev = torch.device("cuda", 0)
    graph = synth_decode_graph(60_000, num_pdfs=2000)
    fwd = DC.build_emit_plan(graph, d=8)
    _f, fwd_dev, bwd, bwd_dev, row_dst = LAT.build_lattice_plans(graph, fwd_plan=fwd, device=dev)
    row_dst = torch.from_numpy(row_dst).to(dev)
    s1, b, k = fwd.num_states + 1, lanes, frames
    rng = np.random.default_rng(0)
    ll = torch.from_numpy((rng.standard_normal((k, 2000, b)) * 5 - 60).astype(np.float32)).to(dev)
    nf = torch.full((b,), 1000, dtype=torch.int32, device=dev)
    alpha = torch.from_numpy((rng.standard_normal((s1, b)) * 10 - 300).astype(np.float32)).to(dev)
    end = torch.full_like(alpha, DC.NEG_INF)
    bps = torch.empty((k, s1, b), dtype=torch.uint8, device=dev)
    final_eff = torch.zeros((s1, b), device=dev)
    slab = torch.empty((k, s1, b), device=dev)
    thresh = torch.full((b,), -1e9, device=dev)
    words = torch.empty((k, fwd.num_rows, b), dtype=torch.uint8, device=dev)
    # K7: 32 lanes x 4 slots, every slot live, lists sorted best first
    nb, nk = 32, 4
    nplan = V.build_nbest_plan(graph, dev)
    lists = -np.sort(-(rng.standard_normal((graph.num_states, nb, nk)) * 10 - 300), axis=2)
    nalpha = torch.from_numpy(lists.astype(np.float32)).to(dev)
    nend = torch.full_like(nalpha, V.NEG_INF)
    nll = ll[:, :, :nb].contiguous()
    nbp = (torch.empty((k, graph.num_states, nb, nk), dtype=torch.int32, device=dev),
           torch.empty((k, graph.num_states, nb, nk), dtype=torch.int8, device=dev))
    n7 = (nf[:nb].contiguous(), 0, 0.077, 1e9)
    # backtrace_best over a 1000-frame table (7.7 GB) that K3 wrote from the
    # start state over random logliks; lanes end at 1000 and, a quarter of
    # them, just before
    gen = torch.Generator(device=dev).manual_seed(0)
    bnf = torch.full((b,), 1000, dtype=torch.int32, device=dev)
    bnf[: b // 4] = torch.arange(1000 - b // 4, 1000, dtype=torch.int32, device=dev)
    table = torch.empty((1000, s1, b), dtype=torch.uint8 if fwd.packed else torch.int16,
                        device=dev)
    bll = torch.randn((1000, 2000, b), generator=gen, device=dev) * 5 - 60
    a0 = np.concatenate([graph.alpha0[fwd.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    balpha = torch.from_numpy(a0).to(dev)[:, None].expand(s1, b).contiguous()
    bae = torch.full_like(balpha, DC.NEG_INF)
    DC.viterbi_window(balpha, bae, bll, fwd_dev, bnf, 0, 0.077, fwd.rspec, fwd.packed, table)
    final = torch.from_numpy(graph.final_score[fwd.sperm[:-1]]).to(dev)
    bend = DC.select_end_state(bae, final)[0].to(torch.int32)
    del bll, balpha, bae
    walk = (table, bend, bnf, 0)
    one = (table[:, :, :1].contiguous(), bend[:1].contiguous(), bnf[:1].contiguous(), 0)
    f = (fwd_dev, nf, 0, 0.077, fwd.rspec, fwd.packed)
    bw = (bwd_dev, nf, 0, 0.077, bwd.rspec, bwd.packed, final_eff)
    fb = (fwd_dev, row_dst, slab, nf, 0, 0.077, thresh, fwd.rspec)
    return {
        "k3_fwd_window_bp": (lambda: DC.viterbi_window(alpha, end, ll, *f, bps), k),
        "k3_fwd_window": (lambda: DC.viterbi_window(alpha, end, ll, *f), k),
        "k3_fwd_frame_bp": (lambda: DC.viterbi_window(alpha, end, ll[:1], *f, bps[:1]), 1),
        "k3_bwd_window": (lambda: LAT.bwd_window(alpha, ll, *bw, slab), k),
        "k3_bwd_frame": (lambda: LAT.bwd_window(alpha, ll[:1], *bw, slab[:1]), 1),
        "k5_window": (lambda: LAT.fb_frames(alpha, ll, *fb, words), k),
        "k5_frame": (lambda: LAT.fb_frames(alpha, ll[:1], *fb[:2], slab[:1], *fb[3:],
                                           words[:1]), 1),
        "k7_window": (lambda: V.nbest_window(nplan, nalpha, nend, nll, *n7, *nbp), k),
        "k7_frame": (lambda: V.nbest_window(nplan, nalpha, nend, nll[:1], *n7, nbp[0][:1],
                                            nbp[1][:1]), 1),
        "backtrace_best": (lambda: DC.backtrace_scan(fwd_dev, *walk), 1),
        "backtrace_best_one_lane": (lambda: DC.backtrace_scan(fwd_dev, *one), 1),
        "backtrace_best_cold": (lambda: DC.backtrace_scan(fwd_dev, *walk), 1),
        "backtrace_best_one_lane_cold": (lambda: DC.backtrace_scan(fwd_dev, *one), 1),
    }, (fwd_dev.row_start, fwd_dev.row_src)


def nbest_walk(plan, arc_src, bp_arc, bp_slot, nf, state, slot):
    """The N-best walk through the current library: the thread-per-walk
    variant's C entry where the library has it, else the tree's wrapper
    (with the plan where it takes one)."""
    lib = _build._lib
    if hasattr(lib, "vbt_backtrace_nbest_thread"):
        t, b = bp_arc.shape[:2]
        c = state.shape[1]
        dev = bp_arc.device
        arcs = torch.empty((t, b, c), dtype=torch.int32, device=dev)
        start = torch.empty((b, c), dtype=torch.int32, device=dev)
        ok = torch.empty((b, c), dtype=torch.uint8, device=dev)
        err = lib.vbt_backtrace_nbest_thread(
            bp_arc.data_ptr(), bp_slot.data_ptr(), *bp_arc.stride(), arc_src.data_ptr(),
            nf.data_ptr(), state.data_ptr(), slot.data_ptr(), b, c, t, arcs.data_ptr(),
            start.data_ptr(), ok.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backtrace_nbest_thread: CUDA error {err}")
        return arcs, start, ok.bool()
    if "arc_src" in V.NbestPlan._fields:
        return V.nbest_walk(plan, bp_arc, bp_slot, nf, state, slot)
    return V.nbest_walk(bp_arc, bp_slot, arc_src, nf, state, slot)


def nbest_cases() -> tuple:
    """The N-best walk at the full-width N-best decode's shape: returns the
    kernel cases, the wrapper's call and the arrays a caller keeps in L2."""
    dev = torch.device("cuda", 0)
    graph = synth_decode_graph(60_000, num_pdfs=2000)
    plan = V.build_nbest_plan(graph, dev)
    arc_src = torch.from_numpy(graph.arc_src).to(dev)
    b, k, c, t = 32, 4, 16, 1000
    rng = np.random.default_rng(0)
    ll = torch.from_numpy((rng.standard_normal((b, t, 2000)) * 5 - 60).astype(np.float32)).to(dev)
    nf_np = np.full(b, t, np.int32)
    ae, bp_arc, bp_slot = V.viterbi_nbest_forward(plan, graph.alpha0, ll, nf_np, 0.077, 1e9, k)
    del ll
    final = torch.from_numpy(graph.final_score).to(dev)
    s = graph.num_states
    fidx = (ae + final[None, :, None]).reshape(b, s * k).sort(dim=1, descending=True,
                                                             stable=True)[1][:, :c]
    nf = torch.from_numpy(nf_np).to(dev)
    walk = (plan, arc_src, bp_arc, bp_slot, nf, (fidx // k).to(torch.int32),
            (fidx % k).to(torch.int32))
    one = (plan, arc_src, bp_arc[:, :1], bp_slot[:, :1], nf[:1].contiguous(),
           walk[5][:1, :1].contiguous(), walk[6][:1, :1].contiguous())
    ref = nbest_walk(*walk)
    given = {"plan": plan} if "plan" in inspect.signature(V.backtrace_nbest_device).parameters \
        else {}

    def wrapper():
        return V.backtrace_nbest_device(graph, ae, bp_arc, bp_slot, nf_np, k, **given)

    warm = tuple(x for x in plan) + (arc_src, nf, walk[5], walk[6])
    todo = {
        "backtrace_nbest": (lambda: nbest_walk(*walk), 1),
        "backtrace_nbest_one_walk": (lambda: nbest_walk(*one), 1),
        "backtrace_nbest_cold": (lambda: nbest_walk(*walk), 1),
        "backtrace_nbest_one_walk_cold": (lambda: nbest_walk(*one), 1),
    }
    return todo, warm, wrapper, (walk, ref)


def time_wrapper(fn, reps: int = 5) -> dict:
    """Wall ms per call of a wrapper that ends in a synchronisation, and
    its device time and activities a call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    prof = C.device_profile(torch, fn)
    return {"wall_ms": wall, "device_ms": prof["device_ms"],
            "activities_per_call": prof["activities_per_call"],
            "device_ms_by_name": prof["device_ms_by_name"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--cases", choices=("all", "nbest"), default="all")
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_viterbi_kernels: CUDA is not available", file=sys.stderr)
        return 1
    load(Path(args.tree).resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sources = {"checkout": None}
    sources.update((n, Path(d)) for n, d in (v.split("=", 1) for v in args.variant))
    libs = {name: build(f"{args.label}_{name}", d) for name, d in sources.items()}
    todo, warm, wrappers = {}, {}, {}
    if args.cases == "all":
        cases_k, warm_k = cases(args.lanes, args.frames)
        todo.update(cases_k)
        warm.update((case, warm_k) for case in cases_k)
    cases_n, warm_n, wrapper, (walk, ref) = nbest_cases()
    todo.update(cases_n)
    warm.update((case, warm_n) for case in cases_n)
    res: dict = {"card": card, "tree": args.tree, "label": args.label, "lanes": args.lanes,
                 "frames": args.frames, "ms_per_frame": {}, "wrapper": []}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            _build._lib = libs[name][0]
            got = nbest_walk(*walk)
            if not all(bool(torch.equal(x, y)) for x, y in zip(got, ref)):
                raise RuntimeError(f"{name}: the N-best walk differs from the package's")
            for case, (fn, frames) in todo.items():
                t = ms_cold(fn, warm[case]) if case.endswith("_cold") else ms(fn)
                res["ms_per_frame"].setdefault(name, {}).setdefault(case, []).append(t / frames)
            if name == "checkout":
                res["wrapper"].append(time_wrapper(wrapper))
    res["spills"] = {name: sorted({ln.split(":")[-1].strip() for ln in rep.splitlines()
                                   if "spill stores" in ln and "0 bytes spill stores" not in ln})
                     for name, (_lib, rep) in libs.items()}
    _build._lib = None
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

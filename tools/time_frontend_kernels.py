"""Time the front-end kernels of voicebridge_tpu_torch, K1 (MFCC frames,
``csrc/mfcc.cu``) and K2 (GMM log-likelihoods, ``csrc/gmm_loglik.cu``), at
full width on one NVIDIA GPU, for the checkout's sources and for other
versions of them side by side.

    python tools/time_frontend_kernels.py [--parent DIR] [--variant NAME=DIR ...]
                                          [--sizes 256,400,512,1024,2048] [--cuts]
                                          [--bits NAME]

Shapes: K2 at 128,000 frames (standard normal features) of three models:
``k2`` 2000 pdfs x 5 Gaussians x 39 dims (``testing.random_am``, every slot
live), ``k2_tri2b`` 2,500 pdfs and 15,000 Gaussians in 16 slots and
``k2_tri5b`` 5,000 and 100,000 in 64 slots, both D = 40 and allotted by
occupancy as the benchmark's configurations ``tri2b-libri`` and
``tri5b-libri`` (``tests/k2_cases.py``); K1 at 128,000 frames of tones and
noise at each padded window size of ``--sizes`` (23 mel bins, 13 cepstra).
Each version's library is built with the package's nvcc flags under
``_archive/kernel_variants/`` and called directly through ctypes, its output
held to the plain version (max abs error; K2's first 2,048 frames against
float64), then timed with CUDA events (mean of 5 calls after a warm-up), all
versions in order and then in reverse.  K2's bounds count the live
Gaussians.

* ``--variant NAME=DIR``: a directory holding ``gmm_loglik.cu`` and/or
  ``mfcc.cu`` with the checkout's C interface, or, for K2, the dense one of
  ``tools/kernel_variants/k2_dense`` (weights as one ``[M_pad, K_pad,
  P_pad]`` slab: that kernel, the checkout's before it scored only live
  Gaussians, and ``k2_fp32``), told apart by the source's signature.
* ``--parent DIR``: the two sources of the earlier kernels, with their C
  interface (K2 weights as ``[P, M, 2D+1]``, K1 at 256 and 512 points with a
  dense mel table); ``git archive`` the commit before the redesign to get
  them.
* ``--bits NAME``: K1's rows of the variant ``NAME`` and of the checkout,
  in ``mfcc`` and in ``fbank`` mode at every size, must be the same bits
  (``bit_equal`` in the output; a difference exits 1): a change to
  ``mfcc.cu`` that keeps those two modes as they were.
* ``--cuts``: versions of the checkout's (and the parent's) sources with
  one stage cut out, to see where their time goes: K2 without the
  logsumexp, the operand split, the FADD of each k-step, two of the three
  products, or the weight staging; K1 without the mel, the DCT or the FFT.
  Their outputs are wrong by design; only their times count.

Also times the plain versions and, for K2, ``torch.matmul`` of the product
alone ([N, 79] @ [79, P*M], no TF32) as a yardstick.  Prints one JSON object
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from voicebridge_tpu_torch import _build  # noqa: E402
from voicebridge_tpu_torch.config import FrameOptions, MelOptions, MfccOptions  # noqa: E402
from voicebridge_tpu_torch.ops import features, gmm_kernel, gmm_kernels  # noqa: E402
from voicebridge_tpu_torch.testing import random_am  # noqa: E402

sys.path.insert(0, str(ROOT / "tests"))
import k2_cases  # noqa: E402

OUT = ROOT / "_archive" / "kernel_variants"
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
SIZES = {200: (8000.0, False), 256: (8000.0, True), 400: (16000.0, False),
         512: (16000.0, True), 551: (22050.0, False), 1024: (22050.0, True),
         1200: (48000.0, False), 2048: (48000.0, True)}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
PARENT_SIGNATURES = {
    "vbt_mfcc_frames": (_P, _I64, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _F, _I, _F, _I,
                        _P, _P),
    "vbt_gmm_loglikes": (_P, _I64, _I, _P, _I, _I, _P, _P),
}
# x, n, d, wt [M_pad, K_pad, P_pad], p, m_pad, mc, out, stream
DENSE_K2_SIGNATURE = (_P, _I64, _I, _P, _I, _I, _I, _P, _P)
K2_FRAMES = 128_000
K2_REF_FRAMES = 2048
# stage cuts of the parent's sources: (source, text, replacement)
CUTS = {
    "parent_k2_no_logsumexp": ("gmm_loglik.cu", """        const float s = acc[i][j];
        if (s > 0.5f * kNeg) {""", """        const float s = acc[i][j];
        mx[i][j] = fmaxf(mx[i][j], s);
        if (false) {"""),
    "parent_k2_no_staging": ("gmm_loglik.cu",
                             "    for (int idx = threadIdx.x; idx < kTileP * kdim; idx += kThreads) {",
                             "    if (c == 0) for (int idx = threadIdx.x; idx < kTileP * kdim; "
                             "idx += kThreads) {"),
    "parent_k1_no_mel": ("mfcc.cu",
                         "for (int kk = 0; kk < kHalf; ++kk) acc += re[kk] * mel_t[kk * num_bins + b];",
                         "acc = re[b] * mel_t[b];"),
    "parent_k1_no_dct": ("mfcc.cu",
                         "for (int b = 0; b < num_bins; ++b) acc += im[b] * dct_t[b * num_ceps + c];",
                         "acc = im[c] * dct_t[c];"),
    "parent_k1_no_fft": ("mfcc.cu", "for (int len = 2; len <= N; len <<= 1) {",
                         "for (int len = 2; len <= 1; len <<= 1) {"),
}
# the same for the checkout's sources
CHECKOUT_CUTS = {
    "k2_no_logsumexp": ("gmm_loglik.cu", """      float s = sm[o] * __expf(mx[o] - nm);
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const float v = acc[c][i][r];
        s += v > 0.5f * kNeg ? __expf(v - nm) : 0.f;
      }""", """      float s = sm[o];
#pragma unroll
      for (int c = 0; c < MC; ++c) s += acc[c][i][r];"""),
    "k2_no_split": ("gmm_loglik.cu", """  hi = tf32_bits(__float_as_uint(v));
  lo = tf32_bits(__float_as_uint(v - __uint_as_float(hi)));""", """  hi = __float_as_uint(v);
  lo = hi;"""),
    "k2_no_fadd": ("gmm_loglik.cu", """        float s[4] = {0.f, 0.f, 0.f, 0.f};
        mma(s, al[i], bh0, bh1);
        mma(s, ah[i], bl0, bl1);
        mma(s, ah[i], bh0, bh1);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c][i][r] += s[r];""", """        mma(acc[c][i], al[i], bh0, bh1);
        mma(acc[c][i], ah[i], bl0, bl1);
        mma(acc[c][i], ah[i], bh0, bh1);"""),
    "k2_one_mma": ("gmm_loglik.cu", """        mma(s, al[i], bh0, bh1);
        mma(s, ah[i], bl0, bl1);
        mma(s, ah[i], bh0, bh1);""", """        mma(s, ah[i], bh0, bh1);"""),
    "k2_no_staging": ("gmm_loglik.cu",
                      "      for (int idx = tid; idx < mc * kp * (kSubP / 4); idx += kThreads) {",
                      "      if (s == blockIdx.y * kSubTiles && c0 == 0)\n"
                      "      for (int idx = tid; idx < mc * kp * (kSubP / 4); idx += kThreads) {"),
    "k1_no_mel": ("mfcc.cu", """#pragma unroll 8
    for (int i = 0; i < len; ++i) acc = fmaf(pw[lo + i], tl.mel_band[i * nb + b], acc);""",
                  """    acc = pw[lo] * len;"""),
    "k1_no_dct": ("mfcc.cu", """    for (int b = 0; b < nb; ++b) acc = fmaf(logmel[b], dct[b * nc + c], acc);""",
                  """    acc = logmel[c];"""),
    "k1_no_fft": ("mfcc.cu", """  fft_passes<M, T, 1>(z, tw, j, group);""", ""),
}


def build_all(versions: dict) -> dict:
    """``versions``: name -> (interface, {source name: path}).  Compiles every
    source of every version at once (one nvcc each), links one library per
    version; returns name -> (interface, CDLL, compiler report)."""
    nvcc = _build._nvcc()
    jobs = []
    for name, (_iface, srcs) in versions.items():
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        for src, path in srcs.items():
            obj = out / f"{src}.o"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj), str(path)]
            jobs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    reports: dict = {}
    for name, _obj, proc in jobs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text}")
        reports[name] = reports.get(name, "") + text
    libs = {}
    for name, (iface, srcs) in versions.items():
        lib_path = OUT / name / "libvariant.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib_path),
                        *[str(OUT / name / f"{s}.o") for s in srcs]], check=True)
        lib = ctypes.CDLL(str(lib_path))
        sigs = PARENT_SIGNATURES if iface == "parent" else _build._SIGNATURES
        for fn, src in (("vbt_mfcc_frames", "mfcc.cu"), ("vbt_gmm_loglikes", "gmm_loglik.cu")):
            if src not in srcs:
                continue
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        if iface != "parent" and "gmm_loglik.cu" in srcs and k2_is_dense(srcs["gmm_loglik.cu"]):
            iface = "dense"
            lib.vbt_gmm_loglikes.argtypes = DENSE_K2_SIGNATURE
        libs[name] = (iface, lib, reports.get(name, ""))
    return libs


def k2_is_dense(path) -> bool:
    """Whether a K2 source takes its weights as one dense slab (``m_pad``,
    ``mc``) rather than the checkout's ragged slabs (``tiles``, ``order``)."""
    return "const int* tiles" not in Path(path).read_text()


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


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def k2_case(dev, name: str):
    """(inputs, float64 plain output of the first frames, work) of a K2
    shape; the work counts the live Gaussians."""
    if name == "k2":
        d, am = 39, random_am(2000, 5, 39)
    else:
        d = 40
        am = k2_cases.am_with_live(k2_cases.live_mask(name[3:] + "_libri"), d, seed=d)
    gmm = gmm_kernels.pack_gmm(am, dev)
    w = gmm.w
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((K2_FRAMES, d), dtype=np.float32)).to(dev)
    ref = gmm_kernels.loglikes(gmm.to(torch.float64), x[:K2_REF_FRAMES].double())
    lay = gmm_kernel.layout(gmm.live)
    n, p = x.shape[0], w.shape[0]
    work = {"bytes": 4 * (x.numel() + lay.live * w.shape[2] + n * p),
            "fp32_ops": 2 * n * lay.live * 2 * d,
            "tf32x3_ops": 3 * 2 * n * lay.live * gmm_kernel.k_pad(w.shape[2]),
            "live": lay.live, "slots": lay.slots, "dense_slots": -(-p // 16) * 16 * w.shape[1]}
    return (x, gmm, dense_slab(w), gmm_kernel.pack_weights(w, lay)), ref, work


def dense_slab(w):
    """(``wt [M_pad, K_pad, P_pad]``, components a pass) for the dense
    kernels: ``wt[c, k, p] = w[p, c, k]``, K padded with zeros to a multiple
    of 8, P to 64, the components to equal passes of at most 5, the padded
    ones inactive."""
    p, m, k = w.shape
    passes = -(-m // 5)
    mc = -(-m // passes)
    wt = w.new_zeros((mc * passes, gmm_kernel.k_pad(k), -(-p // 64) * 64))
    wt[:m, :k, :p] = w.permute(1, 2, 0)
    wt[m:, k - 1] = gmm_kernel.NEG
    return wt, mc


def k1_case(dev, n_fft: int, frames: int):
    sr, pow2 = SIZES[n_fft]
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0,
                                               round_to_power_of_two=pow2),
                       mel_opts=MelOptions(num_bins=23))
    fo = opts.frame_opts
    assert fo.padded_window_size == n_fft
    gen = torch.Generator(device=dev).manual_seed(n_fft)
    ws = fo.window_size
    t = torch.arange(ws, device=dev) / sr
    f = 100 + 1400 * torch.rand((frames, 1), generator=gen, device=dev)
    x = (3000 * torch.sin(2 * math.pi * f * t) + 80 * torch.randn((frames, ws), generator=gen,
                                                                  device=dev)).contiguous()
    tables = features.MfccTables.build(opts, False, dev)
    ref = features.mfcc_from_frames(x, tables)
    nnz = int(tables.mel_len.sum())
    nb, nc = 23, opts.num_ceps
    # per frame: the window chain, a real FFT (an N/2-point complex FFT and
    # its split), the power spectrum, the mel's nonzeros, the DCT, the lifter
    ops = frames * (5 * ws + 5 * (n_fft // 2) * math.log2(n_fft // 2) + 13 * (n_fft // 2)
                    + 2 * nnz + 2 * nb * nc + nc)
    work = {"bytes": 4 * (x.numel() + frames * (nc + 1)), "fp32_ops": ops}
    return (x, tables, opts), ref, work


def call_k1(iface, lib, args, out, mode: int = 0):
    """K1 through ``lib``: ``mode`` 0 cepstra, 1 log-mel rows (``out`` of
    the rows' width)."""
    x, tables, opts = args
    fo = opts.frame_opts
    common = (x.data_ptr(), x.shape[0], fo.window_size, fo.padded_window_size,
              tables.window.data_ptr())
    tail = (opts.mel_opts.num_bins, tables.dct_t.data_ptr(), tables.lifter.data_ptr(),
            opts.num_ceps, int(fo.remove_dc_offset), fo.preemph_coeff, int(opts.raw_energy),
            tables.mel_floor, mode, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if iface == "parent":
        half = tables.twiddle[: fo.padded_window_size // 2].contiguous()
        check(lib.vbt_mfcc_frames(*common, half.data_ptr(), tables.mel_t.data_ptr(), *tail),
              "mfcc_frames")
    else:
        check(lib.vbt_mfcc_frames(*common, tables.twiddle.data_ptr(), tables.mel_lo.data_ptr(),
                                  tables.mel_len.data_ptr(), tables.mel_band.data_ptr(), *tail),
              "mfcc_frames")


def call_k2(iface, lib, args, out):
    x, gmm, (wt, mc), (r_wt, tiles, order) = args
    w = gmm.w
    n, d = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    if iface == "parent":
        check(lib.vbt_gmm_loglikes(x.data_ptr(), n, d, w.data_ptr(), w.shape[0], w.shape[1],
                                   out.data_ptr(), stream), "gmm_loglikes")
    elif iface == "dense":
        check(lib.vbt_gmm_loglikes(x.data_ptr(), n, d, wt.data_ptr(), w.shape[0], wt.shape[0],
                                   mc, out.data_ptr(), stream), "gmm_loglikes")
    else:
        check(lib.vbt_gmm_loglikes(x.data_ptr(), n, d, r_wt.data_ptr(), tiles.data_ptr(),
                                   order.data_ptr(), w.shape[0], out.data_ptr(), stream),
              "gmm_loglikes")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--sizes", default="256,400,512,1024,2048")
    ap.add_argument("--frames", type=int, default=128_000)
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--bits", metavar="NAME")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_frontend_kernels: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    csrc = {s: _build.CSRC / s for s in ("mfcc.cu", "gmm_loglik.cu")}
    versions = {}
    if args.parent is not None:
        versions["parent"] = ("parent", {s: args.parent / s for s in csrc})
    versions["checkout"] = ("checkout", dict(csrc))
    for name, d in (v.split("=", 1) for v in args.variant):
        versions[name] = ("checkout", {s: (Path(d) / s if (Path(d) / s).exists() else p)
                                       for s, p in csrc.items()})
    if args.cuts:
        cuts = [("checkout", _build.CSRC, CHECKOUT_CUTS)]
        if args.parent is not None:
            cuts.append(("parent", args.parent, CUTS))
        for iface, src_dir, table in cuts:
            for name, (src, old, new) in table.items():
                text = (src_dir / src).read_text()
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: {src_dir / src} does not hold the cut's text")
                path = OUT / name / src
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_text(text.replace(old, new))
                versions[name] = (iface, {src: path})
    libs = build_all(versions)
    dev = torch.device("cuda", 0)
    k2 = {name: k2_case(dev, name) for name in ("k2", "k2_tri2b", "k2_tri5b")}
    sizes = [int(s) for s in args.sizes.split(",") if s]
    k1 = {n: k1_case(dev, n, args.frames) for n in sizes}
    res: dict = {"card": card, "frames": args.frames, "ms": {}, "max_abs_err": {},
                 "bound_ms": {}, "plain_ms": {}}
    todo = {}
    for name, (iface, lib, _rep) in libs.items():
        srcs = versions[name][1]
        if "gmm_loglik.cu" in srcs:
            for case, (a, ref, _w) in k2.items():
                if iface == "parent" and case != "k2":
                    continue
                out = torch.empty((K2_FRAMES, ref.shape[1]), device=dev)
                todo[(name, case)] = (lambda i=iface, l=lib, o=out, a=a: call_k2(i, l, a, o),
                                      out, ref)
        if "mfcc.cu" in srcs:
            for n, (a, ref, _w) in k1.items():
                if iface == "parent" and n not in (256, 512):
                    continue
                out = torch.empty_like(ref)
                todo[(name, f"k1_{n}")] = (lambda i=iface, l=lib, o=out, a=a: call_k1(i, l, a, o),
                                           out, ref)
    for (name, case), (fn, out, ref) in todo.items():
        fn()
        torch.cuda.synchronize()
        res["max_abs_err"].setdefault(name, {})[case] = float(
            (out[: len(ref)].double() - ref.double()).abs().max())
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for (lname, case), (fn, _o, _r) in todo.items():
                if lname == name:
                    res["ms"].setdefault(name, {}).setdefault(case, []).append(ms(fn))
    x, params, _slab, _packed = k2["k2"][0]
    xx = torch.cat([x, x * x, torch.ones_like(x[:, :1])], dim=1)
    wm = params.w.reshape(-1, params.w.shape[2]).T.contiguous()  # [2D+1, P*M]
    res["plain_ms"]["k2"] = ms(lambda: gmm_kernels.loglikes(params, x))
    res["matmul_yardstick_ms"] = ms(lambda: xx @ wm)
    res["k2_slots"] = {}
    for case, (_a, _ref, work) in k2.items():
        res["bound_ms"][f"{case}_fp32"] = 1e3 * max(work["bytes"] / HBM_BYTES_PER_S,
                                                    work["fp32_ops"] / FP32_OPS_PER_S)
        res["bound_ms"][f"{case}_tf32x3"] = 1e3 * max(work["bytes"] / HBM_BYTES_PER_S,
                                                      work["tf32x3_ops"] / TF32_OPS_PER_S)
        res["k2_slots"][case] = {k: work[k] for k in ("live", "slots", "dense_slots")}
    for n, (a, _ref, work) in k1.items():
        res["plain_ms"][f"k1_{n}"] = ms(lambda a=a: features.mfcc_from_frames(a[0], a[1]))
        res["bound_ms"][f"k1_{n}"] = 1e3 * max(work["bytes"] / HBM_BYTES_PER_S,
                                               work["fp32_ops"] / FP32_OPS_PER_S)
    res["registers"] = {name: sorted({ln.split(":", 1)[1].strip() for ln in rep.splitlines()
                                      if "registers" in ln and "Used" in ln})
                        for name, (_i, _l, rep) in libs.items()}
    res["spills"] = {name: sorted({ln.split(":")[-1].strip() for ln in rep.splitlines()
                                   if "spill stores" in ln and "0 bytes spill stores" not in ln})
                     for name, (_i, _l, rep) in libs.items()}
    if args.bits:
        res["bit_equal"] = {}
        for n, (a, ref, _w) in k1.items():
            for mode, cols in ((0, ref.shape[1]), (1, a[2].mel_opts.num_bins + 1)):
                outs = []
                for name in (args.bits, "checkout"):
                    iface, lib, _rep = libs[name]
                    outs.append(torch.empty((ref.shape[0], cols), device=dev))
                    call_k1(iface, lib, a, outs[-1], mode)
                torch.cuda.synchronize()
                res["bit_equal"][f"k1_{n}_{('mfcc', 'fbank')[mode]}"] = bool(
                    torch.equal(*outs))
    print(json.dumps(res, indent=1))
    return 0 if all(res.get("bit_equal", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())

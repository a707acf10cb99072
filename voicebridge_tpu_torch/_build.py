"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc``, one
process per source, all started together, and linked into one shared library
with a plain C interface, ``_build/libvbt_kernels_<hash>.so``, keyed by a
hash of the sources and flags, and loaded with ``ctypes``; host C++
libraries are built with ``g++`` the same way (``build_host_library``).  A
failed build or load raises: there is no fallback.  ``nvcc`` is taken from
``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``, else ``PATH``.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only after its kernel launched (``launch`` below).  K3 counts its
launches over the lattice's backward plan apart, as
``viterbi_step_backward``, and K1 its launches in ``mel_power`` mode, as
``mfcc_mel_power``.  The lane-major lattice forward-backward counts one
launch per window and pass (``lattice_lane``), each one cooperative kernel
over the window's frames.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("mfcc.cu", "gmm_loglik.cu", "viterbi_step.cu", "align_band.cu",
           "gmm_stats.cu", "lattice_fb.cu", "viterbi_nbest.cu", "viterbi_generic.cu",
           "backtrace.cu", "lattice_lane.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

launches = {"mfcc_frames": 0, "mfcc_mel_power": 0, "gmm_loglikes": 0, "viterbi_step": 0,
            "viterbi_step_backward": 0, "align_forward": 0, "align_backtrace": 0,
            "gmm_stats": 0, "lattice_fb": 0, "viterbi_nbest": 0, "generic_forward": 0,
            "generic_backtrace": 0, "backtrace_best": 0, "backtrace_nbest": 0,
            "lattice_lane": 0}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # frames, num_frames, ws, n_fft, window, twiddle, mel_lo, mel_len,
    # mel_band, num_bins, dct_t, lifter, num_ceps, remove_dc, preemph,
    # raw_energy, mel_floor, mode (0 mfcc, 1 fbank, 2 mel_power), out, stream
    "vbt_mfcc_frames": (_P, _I64, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _F,
                        _I, _F, _I, _P, _P),
    # x, n, d, wt, tiles, order, p, out, stream
    "vbt_gmm_loglikes": (_P, _I64, _I, _P, _P, _P, _I, _P, _P),
    # alpha, buf0, buf1, alpha_end, bp, bp_bytes, ll, row_start, row_src,
    # row_w, row_pdf, row_real, num_frames, final_eff, slab, t0, w, acwt, s1,
    # b, p, d, reverse, max_blocks, stream
    "vbt_viterbi_step": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _F, _I, _I, _I, _I, _I, _I, _P),
    # W, pdf, alpha0, ll, num_frames, offsets, acwt, b, s, k, t, p,
    # alpha_end, bps, stream
    "vbt_align_forward": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P),
    # alpha_end, final, bps, num_frames, offsets, arc_of, b, s, k, t, arcs,
    # end_state, ok, score, stream
    "vbt_align_backtrace": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # pdf, weights, n, num_pdfs, fpb, nblk, cnt, total, order, blk_pdf,
    # blk_lo, blk_hi, pdf_blk_lo, pdf_blk_hi, ticket, stream
    "vbt_gmm_stats_list": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # x_post, x_acc, weights, d, w, m, pdf, n, num_pdfs, fpb, nblk, cnt,
    # total, order, blk_pdf, blk_lo, blk_hi, pdf_blk_lo, pdf_blk_hi, ticket,
    # partial, out, ll, stream
    "vbt_gmm_stats": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P),
    # alpha, buf0, buf1, words, ll, beta, thresh, row_start, row_src, row_w,
    # row_pdf, row_real, row_dst, num_frames, t0, w, acwt, s1, b, p, r, d,
    # max_blocks, stream
    "vbt_lattice_fb": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                       _I, _I, _I, _I, _I, _I, _P),
    # alpha, buf0, buf1, alpha_end, bp_arc, bp_slot, best, ll, in_start, src,
    # pdf, score, arc, num_frames, t0, w, acwt, beam, b, s, k, p, max_blocks,
    # stream
    "vbt_viterbi_nbest": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                          _F, _I, _I, _I, _I, _I, _P),
    # in_start, in_len, in_src, in_score, in_lpdf, in_arc, pdf_list, n_pdf,
    # alpha0, ll, num_frames, acwt, beam, b, s, a, u, t, p, max_deg,
    # alpha_end, bps, codes, stream
    "vbt_generic_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I,
                            _I, _I, _I, _P, _P, _P, _P),
    # alpha_end, final_score, codes, bps, num_frames, in_start, in_src,
    # in_arc, arc_src, b, s, a, t, arcs, ok, end_state, score, stream
    "vbt_generic_backtrace": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                              _P, _P),
    # bps, bp_bytes, row_start, row_src, row_arc, end_state, num_frames, t0, w,
    # s1, b, d, codes, arcs, state, stream
    "vbt_backtrace_best": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    # bp_arc, bp_slot, stride t, b, s, k, in_start, in_off, in_base, arc, src,
    # arc_src, s, a, num_frames, state, slot, b, c, t, arcs, state_out, ok,
    # stream
    "vbt_backtrace_nbest": (_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                            _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # seq, cut, at_end, scratch, ll, t, p, piece, pieces, hub, hubs, in_src,
    # in_score, in_pdf, num_frames, t0, w, acwt, beam, max_active, b, s, stream
    "vbt_lattice_lane_forward": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _I,
                                 _I, _F, _F, _I, _I, _I, _P),
    # seq, cut, beta, beta_tmp, scratch, ll, t, p, final_eff, thresh, piece,
    # pieces, hub, hubs, out_dst, out_score, out_pdf, out_arc, num_frames, t0,
    # w, acwt, b, s, a, bits, row, stream
    "vbt_lattice_lane_backward": (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P,
                                  _P, _P, _P, _I, _I, _F, _I, _I, _I, _P, _I64, _P),
}

_lib = None


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> Path:
    """Compile the kernels if this exact source set has not been built;
    returns the library path.  The compiler's register/shared-memory report
    is kept beside it as ``.log``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"libvbt_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{name}.o") for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    report = []

    def check(cmd, code, text):
        report.append(text)
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{text}")

    try:
        for cmd, proc in zip(cmds, procs):
            text = proc.communicate()[0]
            check(cmd, proc.returncode, text)
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, check=False)
        check(cmd, res.returncode, res.stdout)
    finally:
        for proc in procs:
            proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(report))
    os.replace(tmp, out)
    return out


# host libraries: no -march=native and no fused multiply-add, the same floats
# on every host
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-ffp-contract=off", "-shared")


def build_host_library(source: Path, stem: str) -> Path:
    """Compile the C++ ``source`` with ``g++`` (``$CXX``) into
    ``_build/<stem>_<hash>.so``, keyed by a hash of the source and flags,
    unless it is there; a failed build raises."""
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *HOST_CXX_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source.name} failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vbt_error_string.argtypes = (ctypes.c_int,)
        lib.vbt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(kernel: str, *args, count: str | None = None) -> None:
    """Call ``vbt_<kernel>`` and raise if it returned a CUDA error; count the
    launch otherwise, under ``count`` (default: the kernel's name)."""
    lib = library()
    err = getattr(lib, "vbt_" + kernel)(*args)
    if err != 0:
        msg = lib.vbt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    launches[count or kernel] += 1

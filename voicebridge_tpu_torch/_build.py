"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc``, one
process per source, all started together, and linked into one shared library
with a plain C interface, ``_build/libvbt_kernels_<hash>.so``, keyed by a
hash of the sources and flags, and loaded with ``ctypes``.  A failed build or
load raises: there is no fallback.  ``nvcc`` is taken from
``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``, else ``PATH``.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one only after its kernel launched (``launch`` below).
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
           "gmm_stats.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

launches = {"mfcc_frames": 0, "gmm_loglikes": 0, "viterbi_step": 0,
            "align_forward": 0, "align_backtrace": 0, "gmm_stats": 0}

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # frames, num_frames, ws, n_fft, window, twiddle, mel_t, num_bins, dct_t,
    # lifter, num_ceps, remove_dc, preemph, raw_energy, mel_floor,
    # fbank_only, out, stream
    "vbt_mfcc_frames": (_P, _I64, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _F,
                        _I, _F, _I, _P, _P),
    # x, n, d, w, p, m, out, stream
    "vbt_gmm_loglikes": (_P, _I64, _I, _P, _I, _I, _P, _P),
    # alpha, alpha_out, alpha_end, bp, bp_bytes, ll_t, row_start, row_src,
    # row_w, row_pdf, num_frames, t, acwt, s1, b, d, stream
    "vbt_viterbi_step": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _F,
                         _I, _I, _I, _P),
    # W, pdf, alpha0, ll, num_frames, offsets, acwt, b, s, k, t, p,
    # alpha_end, bps, stream
    "vbt_align_forward": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P),
    # alpha_end, final, bps, num_frames, offsets, arc_of, b, s, k, t, arcs,
    # end_state, ok, score, stream
    "vbt_align_backtrace": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # x_post, x_acc, weights, d, w, m, order, blk_pdf, blk_lo, blk_hi, nblk,
    # pdf_blk_lo, pdf_blk_hi, num_pdfs, partial, out, stream
    "vbt_gmm_stats": (_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P),
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


def launch(kernel: str, *args) -> None:
    """Call ``vbt_<kernel>`` and raise if it returned a CUDA error; count the
    launch otherwise."""
    lib = library()
    err = getattr(lib, "vbt_" + kernel)(*args)
    if err != 0:
        msg = lib.vbt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
    launches[kernel] += 1

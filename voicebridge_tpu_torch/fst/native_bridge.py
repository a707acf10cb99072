"""ctypes bridge to the native WFST library (``csrc/wfst.cpp``).

The library runs the host-side graph builds (compose, determinize-star,
minimize-encoded, connect, remove-eps-local) ~50-100x faster than the Python
implementations of this package, with the same results
(``tests/test_torch_hostcopy.py`` holds the two to identical FSTs).  It is
compiled with ``g++`` at first use into ``_build/libvbt_wfst_<hash>.so``,
keyed by a hash of the source and flags; no binary is committed and a failed
build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .._build import CSRC, build_host_library
from .core import Arc, Fst, NO_STATE_ID, ZERO

_SOURCE = CSRC / "wfst.cpp"
_LIB = None


class _CGraph(ctypes.Structure):
    _fields_ = [
        ("num_states", ctypes.c_int32),
        ("start", ctypes.c_int32),
        ("num_arcs", ctypes.c_int64),
        ("src", ctypes.POINTER(ctypes.c_int32)),
        ("ilabel", ctypes.POINTER(ctypes.c_int32)),
        ("olabel", ctypes.POINTER(ctypes.c_int32)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("dst", ctypes.POINTER(ctypes.c_int32)),
        ("finals", ctypes.POINTER(ctypes.c_float)),
    ]


def _build():
    return build_host_library(_SOURCE, "libvbt_wfst")


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(_build()))
        for name in ("vb_compose", "vb_determinize_star", "vb_minimize_encoded",
                     "vb_connect", "vb_remove_eps_local"):
            getattr(lib, name).restype = ctypes.c_int
        lib.vb_free_graph.restype = None
        _LIB = lib
    return _LIB


def _to_c(fst: Fst, keep) -> tuple:
    """Returns (_CGraph, keepalive arrays)."""
    src, ilab, olab, wt, dst = fst.to_arrays()
    finals = np.asarray(
        [f if f != ZERO else np.float32(np.inf) for f in fst.finals],
        np.float32)
    g = _CGraph()
    g.num_states = fst.num_states
    g.start = fst.start
    g.num_arcs = len(src)
    arrs = (src, ilab, olab, wt, dst, finals)
    keep.extend(arrs)
    g.src = src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    g.ilabel = ilab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    g.olabel = olab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    g.weight = wt.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    g.dst = dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    g.finals = finals.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return g


def _from_c(lib, g: _CGraph) -> Fst:
    f = Fst()
    n = g.num_states
    na = g.num_arcs
    f.add_states(n)
    f.start = g.start if n else NO_STATE_ID
    if n:
        finals = np.ctypeslib.as_array(g.finals, shape=(n,))
        for s in range(n):
            if np.isfinite(finals[s]):
                f.finals[s] = float(finals[s])
    if na:
        src = np.ctypeslib.as_array(g.src, shape=(na,))
        ilab = np.ctypeslib.as_array(g.ilabel, shape=(na,))
        olab = np.ctypeslib.as_array(g.olabel, shape=(na,))
        wt = np.ctypeslib.as_array(g.weight, shape=(na,))
        dst = np.ctypeslib.as_array(g.dst, shape=(na,))
        for k in range(na):
            f.arcs[src[k]].append(Arc(int(ilab[k]), int(olab[k]),
                                      float(wt[k]), int(dst[k])))
    lib.vb_free_graph(ctypes.byref(g))
    return f


def compose(a: Fst, b: Fst) -> Fst:
    lib = _load()
    keep: list = []
    ca, cb, out = _to_c(a, keep), _to_c(b, keep), _CGraph()
    rc = lib.vb_compose(ctypes.byref(ca), ctypes.byref(cb), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"native compose failed rc={rc}")
    return _from_c(lib, out)


def determinize_star(fst: Fst, use_log: bool = False) -> Fst:
    lib = _load()
    keep: list = []
    cin, out = _to_c(fst, keep), _CGraph()
    rc = lib.vb_determinize_star(ctypes.byref(cin), int(use_log),
                                 ctypes.byref(out))
    if rc == -1:
        raise RuntimeError("native determinize_star: epsilon cycle")
    if rc == -2:
        raise RuntimeError("native determinize_star: FST not functional")
    if rc != 0:
        raise RuntimeError(f"native determinize_star failed rc={rc}")
    return _from_c(lib, out)


def minimize_encoded(fst: Fst) -> Fst:
    lib = _load()
    keep: list = []
    cin, out = _to_c(fst, keep), _CGraph()
    rc = lib.vb_minimize_encoded(ctypes.byref(cin), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"native minimize failed rc={rc}")
    return _from_c(lib, out)


def remove_eps_local(fst: Fst) -> Fst:
    lib = _load()
    keep: list = []
    cin, out = _to_c(fst, keep), _CGraph()
    rc = lib.vb_remove_eps_local(ctypes.byref(cin), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"native remove_eps_local failed rc={rc}")
    return _from_c(lib, out)


def connect(fst: Fst) -> Fst:
    lib = _load()
    keep: list = []
    cin, out = _to_c(fst, keep), _CGraph()
    rc = lib.vb_connect(ctypes.byref(cin), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"native connect failed rc={rc}")
    return _from_c(lib, out)

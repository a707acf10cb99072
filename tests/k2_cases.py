"""Models for the cases of K2's ragged layout (``ops/gmm_kernel.layout``),
shared by the CPU tests of the layout and the card tests of the kernel:
which components are live, and a random model with exactly those live.

``tri2b_libri`` and ``tri5b_libri`` are the benchmark's mixtures (its
configurations ``tri2b-libri``, 2,500 pdfs and 15,000 Gaussians, and
``tri5b-libri``, 5,000 and 100,000): log-normal occupancy shares (sigma 1)
allotted to share ** 0.25 by the benchmark's own ``vbbench.models.allot``,
live in each pdf's first slots of the power of two above the largest count.
The others are the layout's edges."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from voicebridge_tpu_torch.models.gmm import AmDiagGmm

CASES = ("tri2b_libri", "tri5b_libri", "dead_between", "all_dead_beside_16", "one_gaussian",
         "ragged_p", "uniform")


def _allot():
    bench = str(Path(__file__).resolve().parents[1] / "benchmarks")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from vbbench.models import allot

    return allot


def drawn(num_pdfs: int, num_gauss: int, seed: int) -> np.ndarray:
    """``[P, M]`` live components of a mixture drawn as the benchmark's."""
    share = np.exp(np.random.default_rng(seed).standard_normal(num_pdfs))
    n = _allot()(share / share.sum(), num_gauss, 0.25)
    m = 1 << (int(n.max()) - 1).bit_length()
    return np.arange(m)[None] < n[:, None]


def live_mask(case: str) -> np.ndarray:
    """``[P, M]`` bool: which components of ``case``'s model are live."""
    rng = np.random.default_rng(CASES.index(case))
    if case == "tri2b_libri":
        return drawn(2500, 15000, 1)
    if case == "tri5b_libri":
        return drawn(5000, 100000, 2)
    if case == "dead_between":  # live slots anywhere, dead ones between them
        live = rng.random((70, 9)) < 0.5
        live[:, 4] = True
        live[3] = [True, False, False, True, True, False, False, False, True]
        return live
    if case == "all_dead_beside_16":  # pdf 7 sorts into sub-tile 1 with pdfs of 16
        live = np.ones((20, 16), bool)
        live[7] = False
        return live
    if case == "one_gaussian":  # one live slot a pdf, at any slot
        live = np.zeros((90, 8), bool)
        live[np.arange(90), rng.integers(0, 8, 90)] = True
        return live
    if case == "ragged_p":  # 150 pdfs: neither 16 nor 64 divides it
        return np.arange(7)[None] < rng.integers(1, 8, 150)[:, None]
    if case == "uniform":
        return np.ones((200, 5), bool)
    raise KeyError(case)


def am_with_live(live: np.ndarray, dim: int, seed: int) -> AmDiagGmm:
    """A random diagonal GMM whose live components are ``live`` (weight 0
    on the others; a pdf with none has no active Gaussian)."""
    rng = np.random.default_rng(seed)
    shape = live.shape + (dim,)
    inv_vars = np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.3
    means = rng.standard_normal(shape).astype(np.float32)
    weights = (rng.random(live.shape) + 0.1).astype(np.float32) * live
    weights /= np.maximum(weights.sum(axis=1, keepdims=True), 1e-30)
    return AmDiagGmm(means * inv_vars, inv_vars, weights)

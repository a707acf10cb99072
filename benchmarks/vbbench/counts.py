"""The work each layer needs, counted from the cell's shapes: each input
read once, each output written once, and the arithmetic of the algorithm,
whatever layout or padding an implementation chooses.  With the table of
peaks this gives a layer's least time on the card, the numerator of its
roofline share and of the whole step's ``mfu``.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM at its 700 W limit (dense, no
# sparsity): operations a second by precision, and HBM bytes a second.
PEAKS = {"tf32": 495e12, "fp32": 67e12, "fp64": 67e12}
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def least_s(work: dict) -> float:
    """The larger of the operations' time at their peaks and the bytes' time
    at the memory's bandwidth."""
    ops_s = sum(n / PEAKS[peak] for peak, n in work["ops"].items())
    return max(ops_s, work["bytes"] / HBM_BYTES_PER_S)


def ops_s(work: dict) -> float:
    """The operations' time at their peaks alone."""
    return sum(n / PEAKS[peak] for peak, n in work["ops"].items())


def gmm(frames: int, gaussians: int, dim: int, pdfs: int) -> tuple[dict, float]:
    """Per-pdf log-likelihoods of ``frames`` frames: per (frame, Gaussian)
    the product of ``[x, x^2]`` with ``[mean/var, -1/(2 var)]`` and the
    constant, 2 (2D + 1) operations, at the TF32 tensor-core rate, the
    highest any implementation could use; features in, ``[N, P]`` out."""
    return ({"tf32": 2.0 * (2 * dim + 1) * frames * gaussians},
            F32 * frames * (dim + pdfs))


def lattice(frames: int, lanes: int, arcs: int, pdfs: int, survivors: int,
            graph_bytes: int) -> tuple[dict, float]:
    """The lattice forward-backward of ``lanes`` utterances of ``frames``
    frames (or of ``frames`` (frame, utterance) pairs in all, with one lane)
    over a graph of ``arcs`` arcs: the acoustic scale applied once a
    (frame, lane, pdf); per (frame, lane, arc) the forward's two adds and a
    max, the backward's two adds and a max, and the survivor test's add and
    compare: 8 float32 operations.  Log-likelihoods read once, the graph
    read once, each survivor written once as a (frame, arc) pair."""
    ops = 8.0 * frames * lanes * arcs + 1.0 * frames * lanes * pdfs
    return {"fp32": ops}, F32 * frames * lanes * pdfs + graph_bytes + 2 * F32 * survivors


def mfcc(frames: int, window: int, n_fft: int, bins: int, ceps: int,
         samples: int) -> tuple[dict, float]:
    """MFCC of ``frames`` frames: the window's DC removal, energy,
    preemphasis and window (6 a sample), a real FFT of ``n_fft`` points
    (2.5 n log2 n), the power spectrum (3 a bin), the mel triangles (each
    bin in at most two: 4 a bin), the log, the DCT as a dense product and
    the lifter; the samples in, the cepstra out."""
    log2 = n_fft.bit_length() - 1
    half = n_fft // 2
    per_frame = (6 * window + 2.5 * n_fft * log2 + 3 * half + 4 * half + bins
                 + 2 * bins * ceps + ceps)
    return {"fp32": float(per_frame) * frames}, F32 * (samples + frames * ceps)


def banded_alignment(frame_states: int, arcs_per_state: int) -> dict:
    """The Viterbi forward over chain graphs: per (frame, state) an add per
    entering arc, a max over them and the emission's scaled add."""
    return {"fp32": float(frame_states) * (2 * arcs_per_state)}


def aligned_stats(frames: int, gaussians_per_frame: float, dim: int) -> dict:
    """The E-step of a hard alignment: per (frame, Gaussian of its pdf) the
    log-likelihood (2 (2D + 1)), the posterior (about 4) and the three
    accumulations (1 + 2 D + 3 D)."""
    return {"fp32": float(frames) * gaussians_per_frame * (2 * (2 * dim + 1) + 4 + 1 + 5 * dim)}

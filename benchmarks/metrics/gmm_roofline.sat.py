"""K2's least time for the fMLLR decode's three scorings a request (the two
lattice passes and the rescoring; ``counts.gmm``: 2 (2D + 1) products a
frame and Gaussian at the published 100,000 Gaussians, at the TF32 peak,
against features in and log-likelihoods out) over the device time of the
kernels mapped to acoustic scoring, in percent."""

from vbbench import readers


def read(run):
    return readers.roofline(run, "acoustic_scoring")

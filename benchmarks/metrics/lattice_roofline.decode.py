"""The lattice forward-backward's least time on the card (``counts.lattice``:
operations at the fp32 peak against the bytes it must move) over the device
time of the kernels mapped to the lattice layer, in percent."""

from vbbench import readers


def read(run):
    return readers.roofline(run, "lattice")

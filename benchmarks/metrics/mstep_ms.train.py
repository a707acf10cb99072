"""Mean wall time of the benchmark's span around ``train_tri.m_step``
(the host M-step), an iteration."""

from vbbench import readers


def read(run):
    return readers.mean_ms(run, "mstep")

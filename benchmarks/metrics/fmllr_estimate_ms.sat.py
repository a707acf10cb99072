"""The fMLLR estimates of the decode: the program's spans ``fmllr.stats``
(the statistics on the card and their read) and ``fmllr.solve`` (the row
solves on the host), whole durations summed, ms a request."""

from vbbench import program_spans


def read(run):
    parts = [program_spans.span_ms(run, "decode", name, whole=True)
             for name in ("fmllr.stats", "fmllr.solve")]
    return None if None in parts else sum(parts)

"""The host's ``apply_alignments`` (the program's span ``align.apply``),
ms an iteration."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "train", "align.apply")

"""The host's assembly of each sub-batch's alignments (the program's span
``align.assemble``: ``assemble_batched_results`` and the scatter), ms an
iteration."""

from vbbench import program_spans


def read(run):
    return program_spans.span_ms(run, "train", "align.assemble")

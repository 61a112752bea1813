"""Front door: the time-weighted mean over the traced window of the
tickets waiting for a slot (the program's ``frontdoor.pending``
gauge)."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    return None if p is None else p.pending_mean

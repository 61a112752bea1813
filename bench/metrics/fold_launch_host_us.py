"""Back projection, on the host: mean microseconds of an ``engine.fold``
span (the staged batch's stacks, the encoder on the int8 wire and the
kernel's launch)."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    if p is None or not p.launches:
        return None
    return 1e6 * p.fold_s / p.launches

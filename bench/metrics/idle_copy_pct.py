"""Device: the share of the traced window with nothing running on the
card while the host was inside one of the program's blocking copies."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    if p is None or p.idle is None:
        return None
    return 100.0 * p.idle["copy"] / ctx.trace.window_s

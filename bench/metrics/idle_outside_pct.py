"""Device: the share of the traced window with nothing running on the
card while the host was in none of the program's spans (the event loop,
the clients, the benchmark's own sampling)."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    if p is None or p.idle is None:
        return None
    return 100.0 * p.idle["outside"] / ctx.trace.window_s

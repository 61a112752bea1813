"""Ingest, on the host: milliseconds a view inside the program's
blocking copies to the card (``engine.copy.*`` spans with ``blocks``:
the views, the Parker rows' indices, the matrices), which wait for the
stream to drain; the waiting part of ``ingest_host_ms``."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    if p is None or not p.views:
        return None
    return 1e3 * p.copy_s / p.views

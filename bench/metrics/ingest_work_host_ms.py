"""Ingest, on the host: milliseconds a view of ``engine.submit``'s time
outside its blocking copies and its ``engine.fold`` spans (the filter's
launches, staging, the step's bookkeeping and retirement); the working
part of ``ingest_host_ms``."""

from bench.harness import program_spans


def read(ctx):
    p = program_spans.load(ctx)
    if p is None or not p.views:
        return None
    return 1e3 * p.work_s / p.views

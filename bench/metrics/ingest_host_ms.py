"""Ingest, on the host: milliseconds inside the front door's ``submit``
calls (up to each call's first yield to the event loop: the copy, the
filter's launches, staging and the folds it launches) per view
submitted, from the benchmark's own spans."""


def read(ctx):
    calls = ctx.spans.calls.get("submit", 0)
    if not calls:
        return None
    return 1e3 * ctx.spans.seconds["submit"] / (calls * ctx.traffic["chunk"])

"""Ingest, on the device: milliseconds per scan folded in the traced
window of every device operation outside the back projection and the
encoder (host-to-device copies, the filter's FFTs and products, the
staging stacks, the retire clone and zeroing); the benchmark's own
work (the samples the check reads) is left out."""


def read(ctx):
    if ctx.trace is None or not ctx.folds:
        return None
    bp, enc = ctx.layer("back projection"), ctx.layer("encoder")
    s = ctx.trace.device_s(lambda n: not bp(n) and not enc(n)
                           and not ctx.trace.own(n))
    return 1e3 * s / ctx.scans_folded if s > 0 else None

"""Encoder: device milliseconds per scan folded in the traced window of
the int8 wire's row encoder."""


def read(ctx):
    if ctx.trace is None or not ctx.folds:
        return None
    s = ctx.trace.device_s(ctx.layer("encoder"))
    return 1e3 * s / ctx.scans_folded if s > 0 else None

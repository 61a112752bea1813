"""Back projection: the least time of the window's voxel-projection
pairs (views folded times ``L**3``, 37 operations each; bytes: each
scan's volume written once and its views read once as float32; against
the H100's published peaks) as a share of the back-projection kernels'
device time in the traced window."""

from bench.harness.yardstick import least_seconds


def read(ctx):
    if ctx.trace is None or not ctx.folds:
        return None
    s = ctx.trace.device_s(ctx.layer("back projection"))
    if s <= 0:
        return None
    sc = ctx.scan
    return 100.0 * least_seconds(ctx.folds * sc.L ** 3, sc.L, sc.n_proj,
                                 sc.n_v, sc.n_u) / s

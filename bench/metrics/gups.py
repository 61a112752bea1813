"""RabbitCT's ranking metric over wall time: voxel-projection updates
(``L**3 * n_proj`` a scan) served per second of the window, in
billions.  Each returned scan counts with the share of its life, from
``open_scan`` to the device's completion of its volume, that lies in
the window, so a scan that straddles an edge of the window counts in
part and the rate does not jump by whole scans."""


def read(ctx):
    end = ctx.t0 + ctx.seconds
    scans = 0.0
    for r in ctx.records:
        if r.t_done is None:
            continue
        inside = min(r.t_done, end) - max(r.t_open, ctx.t0)
        scans += max(inside, 0.0) / (r.t_done - r.t_open)
    if not scans:
        return None
    return scans * ctx.scan.L ** 3 * ctx.scan.n_proj / ctx.seconds / 1e9

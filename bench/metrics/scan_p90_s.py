"""90th percentile, over every scan opened in the window, of the seconds
from ``open_scan`` to the device's completion of the volume, however
late it came (linear between the order statistics)."""

import statistics


def read(ctx):
    lat = [r.t_done - r.t_open for r in ctx.records if r.t_done is not None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]

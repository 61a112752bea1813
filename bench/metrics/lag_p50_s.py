"""Median, over every scan opened in a paced window, of the seconds from
the scheduled time of the scan's last frame to the device's completion
of its volume, however late it came: what a clinician waits after the
rotation.  The median, not a tail: a window holds some 11 scans, and a
90th percentile of them rests on the slowest one or two, which the
host's own stalls set."""

import statistics


def read(ctx):
    lag = [r.t_done - r.t_last for r in ctx.records
           if r.t_done is not None and r.t_last is not None]
    return statistics.median(lag) if lag else None

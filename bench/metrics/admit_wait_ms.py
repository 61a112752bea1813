"""Front door: mean milliseconds a scan opened in the window waited for
a slot (the tickets' ``admitted_at - arrived``, the front door's own
clock)."""


def read(ctx):
    waits = [r.ticket.admitted_at - r.ticket.arrived for r in ctx.records
             if r.ticket is not None and r.ticket.admitted_at is not None]
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)

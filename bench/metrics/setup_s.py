"""Seconds from the process's start to the window's first submit:
imports, the card, the kernels' libraries, the seeded scans, the front
door and its warm-up (one scan for each client, all at once)."""


def read(ctx):
    return ctx.setup_s
